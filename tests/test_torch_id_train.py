"""Port parity for ID-module training (``iffnerf_tpu_torch/pose/trainer.py``
against ``iffnerf_tpu/pose/trainer.py``) and for ``save_pytree``.

The problem is ``tests/test_id_scan.py``'s: a depth-1 ViT, 48x48 RGBA
images, 256 rays, an accumulation of 2-4; the JAX parameters reach the port
through its weight bridge. The step is fed the NEGATED ray directions, as
both trainers do (reference pose_estimation/train.py:98).

Two leaves are exactly invariant under the loss: ``k_proj.b`` and
``ray_mlp2[1].b`` shift every logit of a patch by the same amount, and the
softmax runs along the ray axis. Their gradients are float32 cancellation
noise, which Adam turns into drift of up to lr a step in either package, so
they are bounded apart, as ``tests/test_id_scan.py`` bounds them."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from iffnerf_tpu.checkpoint import load_pytree as jload_pytree
from iffnerf_tpu.checkpoint import save_pytree as jsave_pytree
from iffnerf_tpu.pose import trainer as jtrainer
from iffnerf_tpu_torch.checkpoint import _flatten, _numpy_leaves
from iffnerf_tpu_torch.checkpoint import load_pytree as tload_pytree
from iffnerf_tpu_torch.checkpoint import save_pytree as tsave_pytree
from iffnerf_tpu_torch.device import tree_map
from iffnerf_tpu_torch.pose import trainer as ttrainer

from torch_parity import configs, params, t

INVARIANT = ("k_proj/b", "ray_mlp2/1/b")
CPU = torch.device("cpu")


def _lr(name):
    return ttrainer.LEARNING_RATES[name.split("/")[0]]


def _flat(tree):
    """JAX or port pytree -> {"a/0/w": float32 numpy}."""
    return {k: np.asarray(v, np.float32)
            for k, v in _flatten(_numpy_leaves(tree)).items()}


def _assert_params_close(p_ref, p_new, steps, lr=None):
    """``tests/test_id_scan.py``'s rule at the rate ``lr``, or at each leaf's
    own rate when None."""
    ref, new = _flat(p_ref), _flat(p_new)
    assert ref.keys() == new.keys()
    for name, a in ref.items():
        rate = _lr(name) if lr is None else lr
        if name in INVARIANT:
            assert np.abs(a - new[name]).max() <= 2.1 * steps * rate, name
        else:
            np.testing.assert_allclose(new[name], a, rtol=1e-3,
                                       atol=max(5e-5, 0.1 * rate),
                                       err_msg=name)


def _assert_grads_close(g_ref, g_new):
    """Each leaf within 1e-4 of its largest magnitude; an invariant bias's
    noise in both packages under 1e-4 of its layer's weight gradient."""
    ref, new = _flat(g_ref), _flat(g_new)
    assert ref.keys() == new.keys()
    for name, a in ref.items():
        if name in INVARIANT:
            scale = np.abs(ref[name[:-1] + "w"]).max()
            assert max(np.abs(a).max(), np.abs(new[name]).max()) \
                < 1e-4 * scale, name
        else:
            assert np.abs(a).max() > 0, name
            err = np.abs(new[name] - a).max()
            assert err <= 1e-4 * np.abs(a).max(), (name, err)


def _tiny_problem(seed, n_imgs=4, n_rays=256):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (n_imgs, 48, 48, 4)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (n_imgs, 1, 1))
    poses[:, 2, 3] = 3.0 + rng.uniform(0, 1, n_imgs)
    ori = rng.uniform(-0.5, 0.5, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rgb = rng.uniform(0, 1, (n_rays, 3)).astype(np.float32)
    return imgs, poses, ori, d, rgb


def _blend(batch):
    """The JAX trainer's host blend: RGBA over white, masks alpha > 0.3."""
    masks = batch[..., -1] > 0.3
    return batch[..., :3] * batch[..., -1:] + (1 - batch[..., -1:]), masks


def test_blend_batch_matches_the_jax_host_blend():
    imgs = _tiny_problem(12)[0]
    imgs[0, :5, :5, 3] = [0.0, 0.3, 0.30001, 0.7, 1.0]
    got = ttrainer.blend_batch(torch.from_numpy(imgs))
    for g, w in zip(got, _blend(imgs)):
        np.testing.assert_array_equal(g.numpy(), w)
    rgb = torch.from_numpy(imgs[..., :3])
    same, masks = ttrainer.blend_batch(rgb)
    assert same is rgb and bool(masks.all())


def _grad_capture():
    """An optax transform that applies nothing and keeps the gradients it
    is handed as its state: the JAX step's summed, divided gradients."""
    return optax.GradientTransformation(
        init=lambda p: jax.tree.map(jnp.zeros_like, p),
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_step(jcfg, jp, tx, accum, rows, imgs, poses, ori, d, rgb):
    """``make_id_train_step`` over the index rows -> (params, opt state,
    losses)."""
    step = jtrainer.make_id_train_step(jcfg, tx, accum)
    p, o = jax.tree.map(jnp.array, jp), tx.init(jp)
    losses = []
    for row in rows:
        blended, masks = _blend(imgs[row])
        p, o, loss = step(p, o, jnp.asarray(blended), jnp.asarray(masks),
                          jnp.asarray(poses[row]), jnp.asarray(ori),
                          jnp.asarray(-d), jnp.asarray(rgb))
        losses.append(float(loss))
    return p, o, losses


def _port_steps(tcfg, tp, accum, rows, imgs, poses, ori, d, rgb):
    """``id_train_step`` over the index rows -> (params, losses, the last
    step's gradients as Adam saw them); each step calls its ``mark`` after
    each of its four parts, in order."""
    p = ttrainer.trainable(tp, CPU)
    opt = ttrainer.make_id_optimizer(p)
    losses = []
    for row in rows:
        blended, masks = _blend(imgs[row])
        marks = []
        loss = ttrainer.id_train_step(p, opt, t(blended), t(masks),
                                      t(poses[row]), t(ori), t(-d), t(rgb),
                                      tcfg, accum, mark=marks.append)
        assert marks == ["ray_features", "image_losses", "ray_backward",
                         "adam"]
        losses.append(float(loss))
    grads = tree_map(lambda x: x.grad, p)
    return p, losses, grads


@pytest.fixture(scope="module")
def problem():
    jcfg, tcfg = configs(depth=1)
    jp, tp = params(3, jcfg)
    return jcfg, tcfg, jp, tp, _tiny_problem(11)


def test_optimizer_groups_match_the_jax_labels(problem):
    _, _, jp, tp, _ = problem
    opt = ttrainer.make_id_optimizer(ttrainer.trainable(tp, CPU))
    by_lr = {g["lr"]: len(g["params"]) for g in opt.param_groups}
    n_backbone = len(jax.tree.leaves(jp["backbone"]))
    assert by_lr == {1e-3: n_backbone,
                     4e-3: len(jax.tree.leaves(jp)) - n_backbone}
    for g in opt.param_groups:
        assert (g["betas"], g["eps"]) == ((0.9, 0.999), 1e-8)


def test_one_step_loss_and_gradients_match_jax(problem):
    """The loss, and every leaf's summed gradient before Adam."""
    jcfg, tcfg, jp, tp, (imgs, poses, ori, d, rgb) = problem
    rows = np.array([[2, 0, 3]])
    _, g_jax, loss_jax = _jax_step(jcfg, jp, _grad_capture(), 3, rows, imgs,
                                   poses, ori, d, rgb)
    _, loss_port, g_port = _port_steps(tcfg, tp, 3, rows, imgs, poses, ori,
                                       d, rgb)
    np.testing.assert_allclose(loss_port, loss_jax, rtol=1e-5)
    _assert_grads_close(g_jax, g_port)


def test_two_steps_match_jax(problem):
    """Parameters after two Adam steps (moments and bias correction
    carried), and both losses."""
    jcfg, tcfg, jp, tp, (imgs, poses, ori, d, rgb) = problem
    rows = np.array([[1, 3], [0, 0]])
    p_jax, _, loss_jax = _jax_step(jcfg, jp, jtrainer.make_id_optimizer(jp),
                                   2, rows, imgs, poses, ori, d, rgb)
    p_port, loss_port, _ = _port_steps(tcfg, tp, 2, rows, imgs, poses, ori,
                                       d, rgb)
    np.testing.assert_allclose(loss_port, loss_jax, rtol=1e-5)
    _assert_params_close(p_jax, p_port, 2)


def test_nan_image_adds_nothing(problem):
    """An image of NaN pixels (its mask still valid) gives a NaN loss: it
    adds no gradient and no loss, the divisor stays accum_steps, and the
    step matches JAX on the same batch."""
    jcfg, tcfg, jp, tp, (imgs, poses, ori, d, rgb) = problem
    imgs = imgs.copy()
    imgs[1, ..., :3] = np.nan
    rows = np.array([[0, 1, 2]])
    _, g_jax, loss_jax = _jax_step(jcfg, jp, _grad_capture(), 3, rows, imgs,
                                   poses, ori, d, rgb)
    _, loss_port, g_port = _port_steps(tcfg, tp, 3, rows, imgs, poses, ori,
                                       d, rgb)
    assert np.isfinite(loss_port[0])
    np.testing.assert_allclose(loss_port, loss_jax, rtol=1e-5)
    _assert_grads_close(g_jax, g_port)
    # the batch without the NaN image, still divided by 3: the same step
    _, loss_two, g_two = _port_steps(tcfg, tp, 3, np.array([[0, 2]]), imgs,
                                     poses, ori, d, rgb)
    assert loss_two == loss_port
    for name, g in _flat(g_two).items():
        np.testing.assert_array_equal(_flat(g_port)[name], g, err_msg=name)


class _FakeDataset:
    def __init__(self, imgs, poses):
        n, h, w, c = imgs.shape
        self.img_wh = (w, h)
        self.all_rgbs = imgs.reshape(n, h * w, c)
        self.poses = poses


def test_train_id_module_matches_jax(problem, tmp_path, monkeypatch):
    """Five iterations with a renewal every two: the same three ray sets in
    the same order, the JAX image-index stream (the port's rng seeded as
    the JAX function seeds its own), the same final parameters and
    model_up."""
    monkeypatch.chdir(tmp_path)  # both trainers write runs/
    jcfg, tcfg, jp, tp, (imgs, poses, _, _, _) = problem
    ds = _FakeDataset(imgs, poses)
    ray_sets = [_tiny_problem(20 + i)[2:] for i in range(3)]

    def generator():
        calls = []

        def gen():
            calls.append(len(calls))
            return ray_sets[len(calls) - 1]

        return gen, calls

    common = dict(n_iterations=5, gradient_accumulation_steps=2,
                  renewal_every_n_iterations=2, log_fn=lambda *_: None)
    key = jax.random.PRNGKey(9)
    gen_j, calls_j = generator()
    p_jax, up_jax = jtrainer.train_id_module(
        key, jax.tree.map(jnp.array, jp), jcfg, gen_j, ds, ds, scan_steps=0,
        **common)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    gen_t, calls_t = generator()
    p_port, up_port = ttrainer.train_id_module(
        tp, tcfg, gen_t, ds, ds, rng=np.random.default_rng(seed),
        device="cpu", **common)

    assert len(calls_j) == len(calls_t) == 3  # renewals at it 0, 2, 4
    np.testing.assert_array_equal(up_port.numpy(), np.asarray(up_jax))
    # the loop's rate as tests/test_id_scan.py holds the same loop: over
    # five steps Adam turns the float32 noise of an element whose gradient
    # is near zero into a step of up to lr (one element of patch_embed.w
    # ends 1.9e-4 apart, beyond 0.1 x its own rate of 1e-3)
    _assert_params_close(p_jax, p_port, 5, lr=4e-3)
    # the caller's parameters are left as they were
    for name, a in _flat(tp).items():
        np.testing.assert_array_equal(a, _flat(jp)[name], err_msg=name)


def test_train_id_module_resumes_and_evaluates(problem, tmp_path,
                                               monkeypatch):
    """start_iterations = n_iterations trains nothing and renews no rays;
    eval_fn runs without grad every val_every_n_iterations."""
    monkeypatch.chdir(tmp_path)
    _, tcfg, _, tp, (imgs, poses, ori, d, rgb) = problem
    ds = _FakeDataset(imgs, poses)
    calls, evals = [], []

    def gen():
        calls.append(1)
        return ori, d, rgb

    p, _ = ttrainer.train_id_module(tp, tcfg, gen, ds, ds, n_iterations=3,
                                    start_iterations=3, device="cpu")
    assert calls == []
    for name, a in _flat(tp).items():
        np.testing.assert_array_equal(_flat(p)[name], a, err_msg=name)

    def eval_fn(params, rays, model_up):
        evals.append(torch.is_grad_enabled())

    ttrainer.train_id_module(tp, tcfg, gen, ds, ds, n_iterations=4,
                             gradient_accumulation_steps=2,
                             val_every_n_iterations=2, eval_fn=eval_fn,
                             log_fn=lambda *_: None, device="cpu")
    assert evals == [False, False] and len(calls) == 1


def test_id_module_npz_loads_in_both_packages(problem, tmp_path):
    """The port's save_pytree loads in the JAX package's load_pytree with
    equal arrays and meta, and the reverse; a bf16 leaf is written as the
    JAX package writes it (2-byte void holding the bits)."""
    _, _, jp, tp, _ = problem
    port_path, jax_path = tmp_path / "port.npz", tmp_path / "jax.npz"
    tsave_pytree(str(port_path), tp, {"epoch": 7})
    tree, meta = jload_pytree(str(port_path))
    assert meta == {"epoch": 7}
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for name, a in _flat(jp).items():
        np.testing.assert_array_equal(_flat(tree)[name], a, err_msg=name)

    jsave_pytree(str(jax_path), jax.tree.map(np.asarray, jp), {"epoch": 5})
    tree, meta = tload_pytree(str(jax_path), device="cpu")
    assert meta == {"epoch": 5}
    assert _flat(tree).keys() == _flat(tp).keys()
    for name, a in _flat(tp).items():
        np.testing.assert_array_equal(_flat(tree)[name], a, err_msg=name)

    vals = np.array([1.5, -2.25, 3e-3], np.float32)
    tsave_pytree(str(port_path), {"a": torch.from_numpy(vals).bfloat16()})
    jsave_pytree(str(jax_path), {"a": jnp.asarray(vals, jnp.bfloat16)})
    with np.load(port_path) as zp, np.load(jax_path) as zj:
        assert zp["a"].dtype == zj["a"].dtype
        np.testing.assert_array_equal(zp["a"].view(np.uint16),
                                      zj["a"].view(np.uint16))
    tree, _ = tload_pytree(str(port_path), device="cpu")
    assert tree["a"].dtype == torch.bfloat16
    assert torch.equal(tree["a"], torch.from_numpy(vals).bfloat16())
