"""The data mesh: the ray axis split over the ranks of a
``torch.distributed`` process group, the counterpart of the JAX package's
``parallel``."""

from iffnerf_tpu_torch.parallel.mesh import (
    Mesh,
    all_gather,
    make_mesh,
    pad_to_multiple,
    pmax,
    psum,
    replicate,
    replicate_arrays,
    shard_rays,
)
