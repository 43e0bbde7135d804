"""Host ms to issue a step: the time inside ``train_step``, no sync (the
window of the traced run)."""

LAYER = "entry: train/trainer.py train_step"
UNIT = "ms"
MOVES = "field_step_ms"
SOURCE = "host_clock"


def read(m):
    return m.host.get("call_ms")
