"""Device ms a frame of the kernels launched while the image side ran (a
span round each call of ``image_queries``: the ViT, the resizes, q)."""

LAYER = "image side: pose/id_module.py image_queries, pose/vit.py"
UNIT = "ms"
MOVES = "pose_images_per_s"
SOURCE = "device_trace"
SPAN = "portbench.image_queries"


def read(m):
    if m.trace is None:
        return None
    s = m.trace.kernel_s_in_span(SPAN)
    return None if not s else s / m.trace.units * 1e3
