"""Weight bridge from the JAX package's parameter pytrees to the port.

The JAX package saves parameters as a flat ``.npz`` whose keys join the
pytree path with ``/`` (``"backbone/blocks/0/qkv/w"``); sequences are
keyed by their decimal index. This module keeps its own copy of that key
scheme, so it reads those files without importing the JAX package.
Layouts are kept as they are: Linear weights ``[in, out]``, the ViT patch
embedding ``[p, p, 3, D]``. Nothing is transposed.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from iffnerf_tpu_torch.device import resolve_device


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def listify(node):
        if not isinstance(node, dict):
            return node
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return tuple(listify(node[str(i)]) for i in range(len(keys)))
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def _to_torch(arr: np.ndarray, device, dtype) -> torch.Tensor:
    arr = np.asarray(arr)
    # bf16 arrives as ml_dtypes.bfloat16 from a live pytree and as 2-byte
    # void from an .npz (numpy does not know the type): torch.from_numpy
    # takes neither, so move the bits and reinterpret them
    if arr.dtype.name == "bfloat16" or (arr.dtype.kind == "V"
                                        and arr.dtype.itemsize == 2):
        t = torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr.copy())
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree_or_flat, device=None, dtype=None):
    """JAX parameters as numpy arrays -- a nested pytree or its flat
    ``"a/b/0/w"`` dict -- -> the port's nested dict of tensors on
    ``device`` (CUDA unless ``device="cpu"``). ``dtype`` casts the
    floating leaves when given."""
    dev = resolve_device(device)
    # a flat dict flattens to itself, so both forms take the same path
    flat = _flatten(tree_or_flat)
    return _unflatten({k: _to_torch(v, dev, dtype) for k, v in flat.items()})


def load_pytree(path: str, device=None, dtype=None):
    """Reads a ``save_pytree`` checkpoint (e.g. the ``id_module.npz`` that
    ``train_eval_pose_est.py`` writes) -> (params, meta dict)."""
    with np.load(path) as z:
        blobs = {k: z[k] for k in z.files}
    meta = {}
    if "meta_json" in blobs:
        meta = json.loads(bytes(blobs.pop("meta_json")).decode())
    return params_from_numpy(blobs, device=device, dtype=dtype), meta
