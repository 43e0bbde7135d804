"""Port parity for the real-scene loaders (``iffnerf_tpu_torch/data``: the
LLFF, Mip-NeRF 360, NSVF and your-own loaders, the COLMAP readers and the
pose normalisation) against the JAX package's, on the scenes the JAX
loader tests write: ``tests/test_loaders.py``'s NSVF and LLFF fixtures,
``tests/test_mip360.py``'s COLMAP scene, and the your-own scene that
``test_your_own_loader_contract`` writes inline. Both packages' loaders
run the same numpy operations, so every array is held bit-equal. Then
``train_cli`` takes two steps with each newly opened config
(``configs/bicycle.txt``, ``wineholder.txt``, ``your_own_data.txt``) on
its loader's scene; ``configs/flower.txt``'s run is in
``tests/test_torch_ndc.py``.
"""

import json
import os
import sys

import numpy as np
import pytest

from iffnerf_tpu.data import dataset_dict as jdataset_dict
from iffnerf_tpu.data import colmap as jcolmap
from iffnerf_tpu.data import pose_utils as jpose_utils
from iffnerf_tpu.data.llff import get_spiral as jget_spiral
from iffnerf_tpu_torch.data import colmap as tcolmap
from iffnerf_tpu_torch.data import dataset_dict
from iffnerf_tpu_torch.data import pose_utils as tpose_utils
from iffnerf_tpu_torch.data.llff import get_spiral

from tests.fixtures import make_blender_fixture
from tests.test_loaders import llff_scene, nsvf_scene  # noqa: F401
from tests.test_mip360 import colmap_scene  # noqa: F401
from torch_parity import one_torch_thread

FIELDS = ("all_rays", "all_rgbs", "poses", "K", "scene_bbox", "directions",
          "render_path")


def _assert_same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None, name
            continue
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert np.asarray(a).dtype == np.asarray(b).dtype, name
    for name in ("near_far", "white_bg", "img_wh", "is_stack", "split",
                 "downsample"):
        assert getattr(got, name) == getattr(want, name), name


def test_registry_names():
    """The JAX registry's names for every ported loader."""
    assert sorted(dataset_dict) == sorted(
        ["blender", "tankstemple", "llff", "mip360", "nsvf", "own_data"])
    for name in dataset_dict:
        assert name in jdataset_dict


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("is_stack", [False, True])
def test_llff_loader_matches(llff_scene, split, is_stack):  # noqa: F811
    """NDC rays, the centred and scaled poses, the 120-pose spiral."""
    want = jdataset_dict["llff"](llff_scene, split=split, downsample=4.0,
                                 is_stack=is_stack)
    got = dataset_dict["llff"](llff_scene, split=split, downsample=4.0,
                               is_stack=is_stack)
    _assert_same(got, want)
    assert got.render_path.shape == (120, 4, 4)


def test_llff_spiral_matches():
    rng = np.random.default_rng(3)
    poses = np.concatenate([np.tile(np.eye(3), (9, 1, 1)),
                            rng.normal(0, 0.2, (9, 3, 1))], -1)
    near_fars = rng.uniform(1.0, 8.0, (9, 2))
    for n in (2, 120):
        np.testing.assert_array_equal(
            get_spiral(poses, near_fars, rads_scale=0.5, n_views=n),
            jget_spiral(poses, near_fars, rads_scale=0.5, n_views=n))


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("is_stack", [False, True])
def test_mip360_loader_matches(colmap_scene, split, is_stack):  # noqa: F811
    """The binary COLMAP model: recentred and rescaled poses, 7-channel
    rays with mip radii."""
    want = jdataset_dict["mip360"](colmap_scene, split=split, downsample=2.0,
                                   is_stack=is_stack)
    got = dataset_dict["mip360"](colmap_scene, split=split, downsample=2.0,
                                 is_stack=is_stack)
    _assert_same(got, want)
    assert got.all_rays.shape[-1] == 7


@pytest.fixture(scope="module")
def colmap_text_scene(colmap_scene, tmp_path_factory):  # noqa: F811
    """``colmap_scene`` with its sparse model written as COLMAP's text
    files (the binary files left out), the images linked."""
    root = tmp_path_factory.mktemp("mip360_text")
    sparse = os.path.join(colmap_scene, "sparse", "0")
    os.makedirs(root / "sparse" / "0")
    os.symlink(os.path.join(colmap_scene, "images"), root / "images")
    cams = jcolmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    imgs = jcolmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
    xyz, rgb, err = jcolmap.read_points3D_binary(
        os.path.join(sparse, "points3D.bin"))
    out = root / "sparse" / "0"
    with open(out / "cameras.txt", "w") as f:
        f.write("# Camera list\n")
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(out / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for im in imgs.values():
            f.write(" ".join([str(im.id)]
                             + [repr(float(v)) for v in (*im.qvec, *im.tvec)]
                             + [str(im.camera_id), im.name]) + "\n\n")
    with open(out / "points3D.txt", "w") as f:
        for i in range(len(xyz)):
            f.write(f"{i} " + " ".join(repr(float(v)) for v in xyz[i])
                    + " " + " ".join(str(int(v)) for v in rgb[i])
                    + f" {float(err[i])!r}\n")
    return str(root)


@pytest.mark.parametrize("split", ["train", "test"])
def test_mip360_loader_matches_on_text_model(colmap_text_scene, split):
    want = jdataset_dict["mip360"](colmap_text_scene, split=split,
                                   downsample=2.0, is_stack=True)
    got = dataset_dict["mip360"](colmap_text_scene, split=split,
                                 downsample=2.0, is_stack=True)
    _assert_same(got, want)


def _assert_same_records(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        for name in want[key]._fields:
            a, b = getattr(got[key], name), getattr(want[key], name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b, err_msg=name)
            else:
                assert a == b, name


def test_colmap_readers_match(colmap_scene, colmap_text_scene):  # noqa: F811
    """Binary and text: cameras, images (with and without 2-D points), the
    point cloud; and qvec2rotmat."""
    for scene, ext in ((colmap_scene, "bin"), (colmap_text_scene, "txt")):
        sparse = os.path.join(scene, "sparse", "0")
        kind = "binary" if ext == "bin" else "text"
        for what in ("intrinsics", "extrinsics"):
            fname = "cameras" if what == "intrinsics" else "images"
            path = os.path.join(sparse, f"{fname}.{ext}")
            _assert_same_records(getattr(tcolmap, f"read_{what}_{kind}")(path),
                                 getattr(jcolmap, f"read_{what}_{kind}")(path))
        path = os.path.join(sparse, f"points3D.{ext}")
        for a, b in zip(getattr(tcolmap, f"read_points3D_{kind}")(path),
                        getattr(jcolmap, f"read_points3D_{kind}")(path)):
            np.testing.assert_array_equal(a, b)
    text = os.path.join(colmap_text_scene, "points_2d.txt")
    with open(text, "w") as f:
        f.write("# comment\n1 1 0 0 0 0.1 0.2 0.3 1 a.png\n"
                "1.0 2.0 7 3.0 4.0 -1\n2 1 0 0 0 0 0 0 1 b.png\n\n")
    _assert_same_records(tcolmap.read_extrinsics_text(text),
                         jcolmap.read_extrinsics_text(text))
    q = np.random.default_rng(0).standard_normal(4)
    np.testing.assert_array_equal(tcolmap.qvec2rotmat(q / np.linalg.norm(q)),
                                  jcolmap.qvec2rotmat(q / np.linalg.norm(q)))


@pytest.mark.parametrize("method", ["fitting", "pca", "given"])
def test_recenter_and_rescale_poses_match(method):
    """A ring of cameras above a plane, recentred by the plane fit, by
    PCA, or by a given average pose; rescaled by their extent and by a
    given scale."""
    rng = np.random.default_rng(4)
    theta = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pos = np.stack([3 * np.cos(theta), 3 * np.sin(theta),
                    1.5 + 0.1 * rng.standard_normal(12)], -1)
    c2w = np.tile(np.eye(4), (12, 1, 1))
    for k, p in enumerate(pos):
        z = -p / np.linalg.norm(p)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        c2w[k, :3, :3] = np.stack([x, np.cross(z, x), z], 1)
        c2w[k, :3, 3] = p
    kw = {"pose_avg": jpose_utils.poses_avg(c2w)} if method == "given" else {
        "method": method}
    got = tpose_utils.recenter_poses(c2w, **kw)
    want = jpose_utils.recenter_poses(c2w, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for scale in (None, 2.5):
        for a, b in zip(tpose_utils.rescale_poses(got[0], scale),
                        jpose_utils.rescale_poses(want[0], scale)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("is_stack", [False, True])
def test_nsvf_loader_matches(nsvf_scene, split, is_stack):  # noqa: F811
    """RGBA blended to white, 6-channel rays, the spherical path."""
    want = jdataset_dict["nsvf"](nsvf_scene, split=split, downsample=8.0,
                                 is_stack=is_stack)
    got = dataset_dict["nsvf"](nsvf_scene, split=split, downsample=8.0,
                               is_stack=is_stack)
    _assert_same(got, want)
    assert got.render_path.shape == (40, 4, 4)


@pytest.fixture(scope="module")
def own_scene(tmp_path_factory):
    """The scene ``tests/test_loaders.py::test_your_own_loader_contract``
    writes: the Blender fixture with colmap2nerf's w, h, cx, cy and
    camera_angle_y."""
    scene = make_blender_fixture(str(tmp_path_factory.mktemp("own") / "scene"),
                                 n_train=3, n_test=1, wh=32)
    for split in ("train", "test"):
        p = os.path.join(scene, f"transforms_{split}.json")
        with open(p) as f:
            meta = json.load(f)
        meta.update({"w": 32, "h": 32, "cx": 16.0, "cy": 16.0,
                     "camera_angle_y": meta["camera_angle_x"]})
        with open(p, "w") as f:
            json.dump(meta, f)
    return scene


@pytest.mark.parametrize("split", ["train", "test"])
@pytest.mark.parametrize("is_stack", [False, True])
def test_your_own_loader_matches(own_scene, split, is_stack):
    want = jdataset_dict["own_data"](own_scene, split=split,
                                     is_stack=is_stack)
    got = dataset_dict["own_data"](own_scene, split=split, is_stack=is_stack)
    _assert_same(got, want)


@pytest.mark.parametrize("config,scene,flags", [
    ("bicycle", "colmap_scene", []),
    ("wineholder", "nsvf_scene", ["--downsample_train", "8"]),
    ("your_own_data", "own_scene", []),
])
def test_train_cli_trains_each_config(config, scene, flags, request,
                                      tmp_path, monkeypatch):
    """``train_cli --config configs/<name>.txt`` on the JAX tests' scene of
    its loader, cut to 2 iterations of 128 rays on a 10^3 grid: it loads
    both splits, trains (a finite mse each step) and saves the field. The
    TensorBoard writer is the trainer's no-op one (importing TensorBoard
    loads TensorFlow here), and torch runs on one thread
    (``one_torch_thread``)."""
    from iffnerf_tpu_torch import train_cli
    from iffnerf_tpu_torch.train import trainer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    args = train_cli.parse_args(
        ["--config", os.path.join(root, "configs", f"{config}.txt"),
         "--datadir", request.getfixturevalue(scene),
         "--basedir", str(tmp_path), "--expname", config, "--device", "cpu",
         "--n_iters", "2", "--batch_size", "128", "--progress_refresh_rate",
         "1", "--N_voxel_init", str(8 ** 3), "--N_voxel_final", str(10 ** 3),
         "--upsamp_list", "100", "--update_AlphaMask_list", "100",
         "--N_vis", "0", "--ckpt_every", "0"] + flags)
    lines = []
    with one_torch_thread():
        cfg, _, _, logfolder = trainer.reconstruction(
            args, log_fn=lines.append, device="cpu")
    mses = [float(ln.split("mse ")[1]) for ln in lines if " mse " in ln]
    assert len(mses) == 2 and all(np.isfinite(mses))
    assert os.path.exists(os.path.join(logfolder, f"{config}.npz"))
    assert cfg.shading_mode == args.shadingMode
