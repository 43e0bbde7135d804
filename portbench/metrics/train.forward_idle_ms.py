"""Idle ms a step of the card whose gap began while the step's forward
(``train.forward``) ran on the host: the dense render's launches."""

from portbench import spans

LAYER = "entry: train/trainer.py train_step"
UNIT = "ms"
MOVES = "field_step_ms"
SOURCE = "program_span"
SPAN = "train.forward"


def read(m):
    if m.trace is None:
        return None
    return spans.idle_under(m.trace, SPAN)
