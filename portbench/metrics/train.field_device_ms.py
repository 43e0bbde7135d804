"""Device ms a step of the field's feature kernels and the alpha-mask
lookup: kernels under ``field.features`` and ``field.mask_lookup``, and
the backward of the autograd nodes made there."""

from portbench import spans

LAYER = "field kernels: ops/field_features.py, ops/cp_features.py, ops/gather.py"
UNIT = "ms"
MOVES = "field_step_ms"
SOURCE = "program_span"
SPANS = ("field.features", "field.mask_lookup")


def read(m):
    if m.trace is None or not spans.opened(m.trace, SPANS):
        return None
    ops = spans.under(m.trace, SPANS)
    ops += spans.backward_of(m.trace, SPANS)
    return spans.device_ms(m.trace, ops)
