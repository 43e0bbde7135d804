"""Device ms a step of the 32 per-image losses and their gradients: CUDA
events at ``id_train_step``'s marks ``ray_features`` and
``image_losses``."""

LAYER = "ID losses: pose/trainer.py per_image_loss"
UNIT = "ms"
MOVES = "id_step_ms"
SOURCE = "program_span"


def read(m):
    return m.marks.get("image_losses_ms")
