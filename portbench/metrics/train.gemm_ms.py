"""Device ms a step of the GEMM kernels (``basis_mat`` and the Ref head,
forward and backward), matched by name: the backward's GEMMs run outside
any forward span."""

LAYER = "shading: models/shading.py, basis_mat"
UNIT = "ms"
MOVES = "field_step_ms"
SOURCE = "device_trace"
KERNELS = r"gemm|gemv|splitK"


def read(m):
    if m.trace is None:
        return None
    s = m.trace.kernel_s(KERNELS)
    return None if not s else s / m.trace.units * 1e3
