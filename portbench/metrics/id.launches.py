"""Device ops (kernels, copies, sets) a step launched under the program's
``id.step`` span, autograd's thread included."""

from portbench import spans

LAYER = "entry: pose/trainer.py id_train_step"
UNIT = "kernels"
MOVES = "id_step_ms"
SOURCE = "program_span"
SPAN = "id.step"


def read(m):
    if m.trace is None or not spans.opened(m.trace, (SPAN,)):
        return None
    return len(spans.under(m.trace, (SPAN,))) / m.trace.units
