"""The frame's model math (ViT-S/14 forward, q, the logits against the
bank) at the float32-accurate peak, over the window's time a frame."""

from portbench.counts import PEAK_F32

LAYER = "entry: pose/solve.py estimate_pose_single_banked"
UNIT = "%"
MOVES = "pose_images_per_s"
SOURCE = "host_clock"


def read(m):
    unit_s = m.host["window_s"] / m.host["units"]
    return 100.0 * m.counts["flops_per_unit"] / PEAK_F32 / unit_s
