"""Device ops (kernels, copies, sets) a step launched under the program's
``train.step`` span, the backward's included."""

from portbench import spans

LAYER = "entry: train/trainer.py train_step"
UNIT = "kernels"
MOVES = "field_step_ms"
SOURCE = "program_span"
SPAN = "train.step"


def read(m):
    if m.trace is None or not spans.opened(m.trace, (SPAN,)):
        return None
    return len(spans.under(m.trace, (SPAN,))) / m.trace.units
