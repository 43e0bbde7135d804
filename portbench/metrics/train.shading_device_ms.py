"""Device ms a step of ``basis_mat`` and the shading head: kernels under
``field.basis_mat`` and ``render.shading``, and the backward of the
autograd nodes made there."""

from portbench import spans

LAYER = "shading: models/shading.py, basis_mat"
UNIT = "ms"
MOVES = "field_step_ms"
SOURCE = "program_span"
SPANS = ("field.basis_mat", "render.shading")


def read(m):
    if m.trace is None or not spans.opened(m.trace, SPANS):
        return None
    ops = spans.under(m.trace, SPANS)
    ops += spans.backward_of(m.trace, SPANS)
    return spans.device_ms(m.trace, ops)
