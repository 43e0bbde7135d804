"""Dataset loaders of the port: host numpy, as in the JAX package."""

from iffnerf_tpu_torch.data.blender import load_blender
from iffnerf_tpu_torch.data.tankstemple import load_tankstemple

dataset_dict = {"blender": load_blender, "tankstemple": load_tankstemple}
