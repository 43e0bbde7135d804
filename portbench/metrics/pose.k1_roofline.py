"""K1's share of its roofline: its least time a frame (the logits'
products at the float32-accurate rate, or the bank read once) over its
kernels' device time a frame."""

LAYER = "scoring: ops/banked_attention.py (K1)"
UNIT = "%"
MOVES = "pose_images_per_s"
SOURCE = "device_trace"
KERNELS = r"banked_pass|sum_shares"


def read(m):
    if m.trace is None:
        return None
    s = m.trace.kernel_s(KERNELS)
    if not s:
        return None
    return 100.0 * m.counts["k1_least_s"] / (s / m.trace.units)
