"""Device ops (kernels, copies, sets) a frame launched under the
program's ``pose.estimate`` span: the host's issue work a frame."""

from portbench import spans

LAYER = "entry: pose/solve.py estimate_pose_single_banked"
UNIT = "kernels"
MOVES = "pose_images_per_s"
SOURCE = "program_span"
SPAN = "pose.estimate"


def read(m):
    if m.trace is None or not spans.opened(m.trace, (SPAN,)):
        return None
    return len(spans.under(m.trace, (SPAN,))) / m.trace.units
