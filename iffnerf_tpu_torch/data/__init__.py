"""Dataset loaders of the port: host numpy, as in the JAX package. The
registry's names are the JAX package's (reference dataLoader/__init__.py:
12-22)."""

from iffnerf_tpu_torch.data.blender import load_blender
from iffnerf_tpu_torch.data.co3d import load_co3d
from iffnerf_tpu_torch.data.co3d_metashape import load_co3d_metashape
from iffnerf_tpu_torch.data.llff import load_llff
from iffnerf_tpu_torch.data.mip360 import load_mip360
from iffnerf_tpu_torch.data.nsvf import load_nsvf
from iffnerf_tpu_torch.data.repair import load_repair
from iffnerf_tpu_torch.data.tankstemple import load_tankstemple
from iffnerf_tpu_torch.data.your_own import load_your_own

dataset_dict = {
    "blender": load_blender,
    "nsvf": load_nsvf,
    "tankstemple": load_tankstemple,
    "llff": load_llff,
    "mip360": load_mip360,
    "repair": load_repair,
    "co3d": load_co3d,
    "co3d_metashape": load_co3d_metashape,
    "own_data": load_your_own,
}


def register_dataset(name: str, loader) -> None:
    """Adds ``loader`` to the registry under ``name`` (the JAX package's
    ``register_dataset``)."""
    dataset_dict[name] = loader
