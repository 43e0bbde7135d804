"""Device ms a frame of the kernels launched under the program's
``pose.topk`` and ``pose.solve`` spans: the exact top-k and the
closed-form solve."""

from portbench import spans

LAYER = "top-k, solve: ops/topk.py, pose/geometry.py"
UNIT = "ms"
MOVES = "pose_images_per_s"
SOURCE = "program_span"
SPANS = ("pose.topk", "pose.solve")


def read(m):
    if m.trace is None or not spans.opened(m.trace, SPANS):
        return None
    ops = spans.under(m.trace, SPANS)
    return spans.device_ms(m.trace, ops)
