"""The step's model math (interpolation, rank products, ``basis_mat``, the
Ref head; forward and backward) at the float32-accurate peak, over the
window's time a step."""

from portbench.counts import PEAK_F32

LAYER = "entry: train/trainer.py train_step"
UNIT = "%"
MOVES = "field_step_ms"
SOURCE = "host_clock"


def read(m):
    unit_s = m.host["window_s"] / m.host["units"]
    return 100.0 * m.counts["flops_per_unit"] / PEAK_F32 / unit_s
