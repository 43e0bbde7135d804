"""Weight bridge from the JAX package's parameter pytrees to the port.

The JAX package saves parameters as a flat ``.npz`` whose keys join the
pytree path with ``/`` (``"backbone/blocks/0/qkv/w"``); sequences are
keyed by their decimal index. This module keeps its own copy of that key
scheme, so it reads and writes those files without importing the JAX
package.
Layouts are kept as they are: Linear weights ``[in, out]``, the ViT patch
embedding ``[p, p, 3, D]``, field planes ``[H, W, R]``. Nothing is
transposed, except by ``load_torch_checkpoint``, which converts the
reference's own ``.th`` field checkpoints into that layout.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from iffnerf_tpu_torch.device import resolve_device
from iffnerf_tpu_torch.models.field import AlphaMask, FieldConfig, make_alpha_mask


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


def _numpy_leaves(tree):
    if isinstance(tree, dict):
        return {k: _numpy_leaves(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return tuple(_numpy_leaves(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bf16: its bits as a 2-byte void, which is how
            # an .npz of the JAX package holds a bf16 leaf
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(tree)


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


def save_pytree(path: str, tree, meta: dict | None = None) -> None:
    """Writes a nested dict/tuple of tensors or arrays as the JAX package's
    ``save_pytree`` does (e.g. ``id_module.npz``): one array a leaf under
    its ``/``-joined path, ``meta`` as JSON bytes under ``meta_json``."""
    blobs = _flatten(_numpy_leaves(tree))
    if meta:
        blobs["meta_json"] = np.frombuffer(json.dumps(meta).encode(),
                                           dtype=np.uint8)
    np.savez(path, **blobs)


def load_pytree(path: str, device=None, dtype=None):
    """Reads a ``save_pytree`` checkpoint (e.g. the ``id_module.npz`` that
    ``train_eval_pose_est.py`` writes) -> (params, meta dict)."""
    with np.load(path) as z:
        blobs = {k: z[k] for k in z.files}
    meta = {}
    if "meta_json" in blobs:
        meta = json.loads(bytes(blobs.pop("meta_json")).decode())
    return params_from_numpy(blobs, device=device, dtype=dtype), meta


# ---------------------------------------------------------------------------
# Field checkpoints: one ``.npz`` with ``params/<path>`` arrays, the alpha
# mask bit-packed (np.packbits) and the FieldConfig as ``config_json``
# (reference models/tensorBase.py:424-458)
# ---------------------------------------------------------------------------


def save_field(path: str, config: FieldConfig, params,
               mask: AlphaMask | None = None) -> None:
    """Writes the JAX package's field checkpoint format."""
    blobs = {f"params/{k}": v for k, v in _flatten(_numpy_leaves(params)).items()}
    if mask is not None:
        vol = mask.volume.detach().cpu().numpy() > 0.5
        blobs["alphaMask.mask"] = np.packbits(vol.reshape(-1))
        blobs["alphaMask.shape"] = np.asarray(vol.shape, np.int64)
        blobs["alphaMask.aabb"] = mask.aabb.detach().cpu().numpy().astype(np.float32)
    blobs["config_json"] = np.frombuffer(
        json.dumps(dataclasses.asdict(config)).encode(), dtype=np.uint8)
    np.savez(path, **blobs)


def _config_from_dict(d: dict) -> FieldConfig:
    """FieldConfig from its JSON dict: keys this version does not know are
    dropped, missing ones take the defaults, JSON lists become tuples."""
    known = {f.name for f in dataclasses.fields(FieldConfig)}
    d = {k: v for k, v in d.items() if k in known}
    d["aabb"] = tuple(map(tuple, d["aabb"]))
    for key in ("grid_size", "density_n_comp", "app_n_comp", "near_far"):
        d[key] = tuple(d[key])
    if "compact_ratios_eval" in d:
        d["compact_ratios_eval"] = tuple(d["compact_ratios_eval"])
    return FieldConfig(**d)


def _mask_from_bits(bits, shape, aabb, config: FieldConfig, dev) -> AlphaMask:
    shape = tuple(int(s) for s in shape)
    vol = np.unpackbits(np.asarray(bits))[:int(np.prod(shape))].reshape(shape)
    return make_alpha_mask(torch.as_tensor(vol, dtype=torch.float32, device=dev),
                           np.asarray(aabb, np.float32), config.contraction_type)


def load_field(path: str, device=None):
    """Reads a field checkpoint -> (config, params, mask | None), the
    tensors on ``device`` (CUDA unless ``device="cpu"``)."""
    dev = resolve_device(device)
    with np.load(path) as z:
        blobs = {k: z[k] for k in z.files}
    config = _config_from_dict(
        json.loads(bytes(blobs.pop("config_json")).decode()))
    mask = None
    if "alphaMask.mask" in blobs:
        mask = _mask_from_bits(blobs.pop("alphaMask.mask"),
                               blobs.pop("alphaMask.shape"),
                               blobs.pop("alphaMask.aabb"), config, dev)
    params = params_from_numpy(
        {k[len("params/"):]: v for k, v in blobs.items()}, device=dev)
    return config, params, mask


_SHADING_MAP_REF = {
    "diffuse_color_mlp.0": "diffuse",
    "tint_color_mlp.0": "tint",
    "roughness_mlp.0": "roughness",
    "bottleneck_mlp": "bottleneck",
    "specular_mlp.0": "specular",
    "normal_mlp.0": "normal",
}


def _linear_from_sd(sd, name):
    """{'w': [in, out], 'b'?} from a torch ``nn.Linear``'s state, or None."""
    w_key = f"{name}.weight"
    if w_key not in sd:
        return None
    layer = {"w": sd[w_key].T}
    if f"{name}.bias" in sd:
        layer["b"] = sd[f"{name}.bias"]
    return layer


def load_torch_checkpoint(path: str, device=None):
    """Converts a reference TensoRF ``.th`` checkpoint ({model_name,
    kwargs, state_dict} + packed alpha mask, models/tensorBase.py:424-458)
    -> (config, params, mask | None) in the JAX package's layout: planes
    [1, R, H, W] -> [H, W, R], lines [1, R, L, 1] -> [L, R], Linear
    weights [out, in] -> [in, out]."""
    dev = resolve_device(device)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    kwargs = ckpt["kwargs"]
    aabb = np.asarray(kwargs["aabb"], dtype=np.float32)
    config = FieldConfig(
        model_name=ckpt["model_name"],
        aabb=tuple(map(tuple, aabb.tolist())),
        grid_size=tuple(int(g) for g in kwargs["gridSize"]),
        density_n_comp=tuple(kwargs["density_n_comp"]),
        app_n_comp=tuple(kwargs["appearance_n_comp"]),
        app_dim=kwargs["app_dim"],
        shading_mode=kwargs["shadingMode"],
        near_far=tuple(float(x) for x in kwargs["near_far"]),
        density_shift=kwargs["density_shift"],
        alpha_mask_thres=kwargs["alphaMask_thres"],
        distance_scale=kwargs["distance_scale"],
        ray_march_weight_thres=kwargs["rayMarch_weight_thres"],
        pos_pe=kwargs["pos_pe"],
        view_pe=kwargs["view_pe"],
        fea_pe=kwargs["fea_pe"],
        feature_c=kwargs["featureC"],
        step_ratio=kwargs["step_ratio"],
        fea2dense_act=kwargs["fea2denseAct"],
        contraction_type=kwargs.get("contraction_type", "aabb"),
    )

    sd = {k: v.detach().cpu().numpy() for k, v in ckpt["state_dict"].items()}
    params: dict = {}
    for kind in ("density", "app"):
        if config.model_name == "TensorVMSplit":
            params[f"{kind}_plane"] = tuple(
                sd[f"{kind}_plane.{i}"][0].transpose(1, 2, 0) for i in range(3))
        params[f"{kind}_line"] = tuple(
            sd[f"{kind}_line.{i}"][0, :, :, 0].T for i in range(3))
    params["basis_mat"] = {"w": sd["basis_mat.weight"].T}

    shading: dict = {}
    if config.shading_mode == "Ref":
        for ref_name, ours in _SHADING_MAP_REF.items():
            layer = _linear_from_sd(sd, f"renderModule.{ref_name}")
            if layer is not None:
                shading[ours] = layer
    else:
        layers = []
        for i in (0, 2, 4):
            layer = _linear_from_sd(sd, f"renderModule.mlp.{i}")
            if layer is None:
                break
            layers.append(layer)
        shading["mlp"] = tuple(layers)
    params["shading"] = shading

    mask = None
    if "alphaMask.aabb" in ckpt:
        mask = _mask_from_bits(ckpt["alphaMask.mask"], ckpt["alphaMask.shape"],
                               ckpt["alphaMask.aabb"], config, dev)
    return config, params_from_numpy(params, device=dev), mask
