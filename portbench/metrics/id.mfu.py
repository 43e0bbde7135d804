"""The step's model math (the ray MLP and k once, each image's ViT, q and
logits; forward and backward) at the float32-accurate peak, over the
window's time a step."""

from portbench.counts import PEAK_F32

LAYER = "entry: pose/trainer.py id_train_step"
UNIT = "%"
MOVES = "id_step_ms"
SOURCE = "host_clock"


def read(m):
    unit_s = m.host["window_s"] / m.host["units"]
    return 100.0 * m.counts["flops_per_unit"] / PEAK_F32 / unit_s
