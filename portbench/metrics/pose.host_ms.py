"""Host ms a frame spends inside ``estimate_pose_single_banked``, no sync:
the host's hold on a frame (the window of the traced run)."""

LAYER = "entry: pose/solve.py estimate_pose_single_banked"
UNIT = "ms"
MOVES = "pose_images_per_s"
SOURCE = "host_clock"


def read(m):
    return m.host.get("call_ms")
