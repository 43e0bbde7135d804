"""Device ms a frame of the kernels launched under the program's
``pose.image_queries`` span: preprocessing, the ViT, q."""

from portbench import spans

LAYER = "image side: pose/id_module.py image_queries, pose/vit.py"
UNIT = "ms"
MOVES = "pose_images_per_s"
SOURCE = "program_span"
SPANS = ("pose.image_queries",)


def read(m):
    if m.trace is None or not spans.opened(m.trace, SPANS):
        return None
    ops = spans.under(m.trace, SPANS)
    return spans.device_ms(m.trace, ops)
