"""Idle ms a step of the card whose gap began while the image losses
(``id.image_losses``) ran on the host."""

from portbench import spans

LAYER = "ID losses: pose/trainer.py per_image_loss"
UNIT = "ms"
MOVES = "id_step_ms"
SOURCE = "program_span"
SPAN = "id.image_losses"


def read(m):
    if m.trace is None:
        return None
    return spans.idle_under(m.trace, SPAN)
