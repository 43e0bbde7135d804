"""The field kernels' share of their roofline: the sum of their least
times a step (features forward and backward, the alpha-mask gather; each
input read once, each output written once) over their device time a
step."""

LAYER = "field kernels: ops/field_features.py, ops/cp_features.py, ops/gather.py"
UNIT = "%"
MOVES = "field_step_ms"
SOURCE = "device_trace"
KERNELS = r"field_features|cp_features|cp_sigma_sum|gather_rows|bucket_count|bucket_place"


def read(m):
    if m.trace is None:
        return None
    s = m.trace.kernel_s(KERNELS)
    if not s:
        return None
    return 100.0 * m.counts["field_least_s"] / (s / m.trace.units)
