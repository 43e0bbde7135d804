"""Port parity for mesh export (``iffnerf_tpu_torch/utils/mesh.py`` and
``csrc/marching_cubes.cpp``) against the JAX package's ``utils/mesh.py``
and its native marching cubes: the triangulation on ``tests/test_mesh.py``'s
sphere and on a seeded random volume (verts and faces equal: the same C++
on the same float32 volume), the PLY bytes, and ``export_mesh_from_field``
on ``torch_parity.field`` (the same faces, verts within 1e-4 of JAX's).
"""

import os

import numpy as np
import pytest

from iffnerf_tpu.checkpoint import load_field as jload_field
from iffnerf_tpu.native import marching_cubes_native as jmarching_cubes
from iffnerf_tpu.utils.mesh import export_mesh_from_field as jexport
from iffnerf_tpu.utils.mesh import write_ply as jwrite_ply
from iffnerf_tpu_torch.models.field import get_dense_alpha as tget_dense_alpha
from iffnerf_tpu_torch.utils import mesh as tmesh

from tests.test_mesh import _sphere_volume
from torch_parity import field


def _random_volume(n, seed):
    """A smooth random volume [n, n+1, n+2]: seeded noise blurred along
    each axis, so that its level sets cross many cells."""
    v = np.random.default_rng(seed).standard_normal((n, n + 1, n + 2))
    for axis in range(3):
        v = (np.roll(v, 1, axis) + v + np.roll(v, -1, axis)) / 3.0
    return v.astype(np.float32)


@pytest.mark.parametrize("case", ["sphere", "random", "empty"])
def test_marching_cubes_matches_jax(case):
    vol, level = {"sphere": (_sphere_volume(40), 0.0),
                  "random": (_random_volume(24, 3), 0.05),
                  "empty": (_sphere_volume(16), 10.0)}[case]
    verts, faces = tmesh.marching_cubes(vol, level)
    want_v, want_f = jmarching_cubes(vol, level)
    np.testing.assert_array_equal(verts, want_v)
    np.testing.assert_array_equal(faces, want_f)
    assert verts.dtype == np.float32 and faces.dtype == np.int32
    assert (len(faces) > 100) == (case != "empty")


def test_write_ply_writes_jax_bytes(tmp_path):
    """JAX's bytes, read back by ``read_ply``; an empty mesh (a level no
    lattice value reaches), on which JAX's writer raises, is a header with
    zero counts."""
    verts, faces = tmesh.marching_cubes(_random_volume(12, 4), 0.0)
    tmesh.write_ply(str(tmp_path / "port.ply"), verts, faces)
    jwrite_ply(str(tmp_path / "jax.ply"), verts, faces)
    got = (tmp_path / "port.ply").read_bytes()
    assert got == (tmp_path / "jax.ply").read_bytes()
    assert got.startswith(b"ply\nformat binary_little_endian 1.0\n")
    back = tmesh.read_ply(tmp_path / "port.ply")
    np.testing.assert_array_equal(back[0], verts)
    np.testing.assert_array_equal(back[1], faces)
    empty = tmp_path / "empty.ply"
    tmesh.write_ply(str(empty), *tmesh.marching_cubes(_random_volume(8, 4),
                                                     10.0))
    assert [len(a) for a in tmesh.read_ply(empty)] == [0, 0]
    assert b"element vertex 0\n" in empty.read_bytes()


def test_library_is_built_into_the_build_directory():
    """The library comes from the repo's source, under build/ (which
    .gitignore lists), named by the source's hash."""
    path = tmesh.build()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == tmesh.library_path() and path.exists()
    assert str(path).startswith(os.path.join(root, "build", "host"))
    assert tmesh.SOURCE.name == "marching_cubes.cpp"


def test_export_mesh_from_field_matches_jax(tmp_path):
    """torch_parity.field's dense alpha at its 20^3 grid, the surface at a
    level that no lattice value lies within 1e-6 of: the same faces as
    JAX's export, verts within 1e-4 (the alphas agree to float32 noise,
    which moves a vertex along its edge)."""
    _, (tcfg, tp, tmask) = field(tmp_path, seed=1)
    jcfg, jp, jmask = jload_field(str(tmp_path / "field_TensorVMSplit_1.npz"))
    alpha = tget_dense_alpha(tcfg, tp, tmask)[0].numpy()
    values = np.sort(alpha[alpha > 0.0])
    lo, hi = len(values) // 10, 9 * len(values) // 10
    k = lo + int(np.argmax(np.diff(values[lo:hi])))
    level = float((values[k] + values[k + 1]) / 2)
    assert np.abs(alpha - level).min() > 1e-6
    jexport(jcfg, jp, jmask, str(tmp_path / "jax.ply"), level=level)
    log = {}
    tmesh.export_mesh_from_field(tcfg, tp, tmask, str(tmp_path / "port.ply"),
                                 level=level, log=log)
    got_v, got_f = tmesh.read_ply(tmp_path / "port.ply")
    want_v, want_f = tmesh.read_ply(tmp_path / "jax.ply")
    assert len(got_f) > 100 and log["n_faces"] == len(got_f)
    np.testing.assert_array_equal(got_f, want_f)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-4)
    aabb = tcfg.aabb_np
    assert (got_v >= aabb[0] - 1e-6).all() and (got_v <= aabb[1] + 1e-6).all()
