"""Device ms a step of the kernels launched under the program's
``id.image_losses`` span: the 32 per-image losses and their gradients,
autograd's thread included."""

from portbench import spans

LAYER = "ID losses: pose/trainer.py per_image_loss"
UNIT = "ms"
MOVES = "id_step_ms"
SOURCE = "program_span"
SPANS = ("id.image_losses",)


def read(m):
    if m.trace is None or not spans.opened(m.trace, SPANS):
        return None
    ops = spans.under(m.trace, SPANS)
    return spans.device_ms(m.trace, ops)
