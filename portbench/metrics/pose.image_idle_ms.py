"""Idle ms a frame of the card whose gap began while the image side
(``pose.image_queries``) ran on the host: the eager ViT's issue holding
the card."""

from portbench import spans

LAYER = "image side: pose/id_module.py image_queries, pose/vit.py"
UNIT = "ms"
MOVES = "pose_images_per_s"
SOURCE = "program_span"
SPAN = "pose.image_queries"


def read(m):
    if m.trace is None:
        return None
    return spans.idle_under(m.trace, SPAN)
