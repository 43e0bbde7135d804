"""The port's spans and counters (``iffnerf_tpu_torch/tracing.py``) under a
CPU ``torch.profiler``, at tiny sizes: which spans a banked pose estimate,
a field training step and an ID training step open and how they nest;
that nothing is recorded or reduced with no profiler; the render counters
against masks worked out here; and the trainers' ``mark`` labels."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from iffnerf_tpu_torch import tracing
from iffnerf_tpu_torch.device import trainable
from iffnerf_tpu_torch.models.field import (
    FieldConfig,
    compute_features,
    feature2density,
    init_field,
    make_alpha_mask,
    normalize_coord,
    sample_alpha,
)
from iffnerf_tpu_torch.models.render import render_rays, sample_ray
from iffnerf_tpu_torch.ops.ray_march import raw2alpha
from iffnerf_tpu_torch.pose.id_module import IDConfig, init_id_module, ray_bank
from iffnerf_tpu_torch.pose.solve import estimate_pose_single_banked
from iffnerf_tpu_torch.pose.trainer import (
    blend_batch,
    id_train_step,
    make_id_optimizer,
)
from iffnerf_tpu_torch.pose.vit import ViTConfig
from iffnerf_tpu_torch.train.trainer import make_optimizer, train_step

CPU = torch.device("cpu")
NAMES = {name for name, _ in tracing.SPANS}
N_IMAGES = 2

# (span, the program span it opens inside) of each unit, roots under None
EDGES = {
    "pose": {("pose.estimate", None),
             ("pose.image_queries", "pose.estimate"),
             ("pose.score", "pose.estimate"),
             ("pose.topk", "pose.estimate"),
             ("pose.solve", "pose.estimate")},
    "train": {("train.step", None),
              ("train.forward", "train.step"),
              ("render.sample", "train.forward"),
              ("field.mask_lookup", "render.sample"),
              ("trace.count", "render.sample"),
              ("field.features", "train.forward"),
              ("field.basis_mat", "train.forward"),
              ("trace.count", "train.forward"),
              ("render.shading", "train.forward"),
              ("train.backward", "train.step"),
              ("train.adam", "train.step")},
    "id": {("id.step", None),
           ("id.ray_features", "id.step"),
           ("id.image_losses", "id.step"),
           ("id.image_loss", "id.image_losses"),
           ("pose.image_queries", "id.image_loss"),
           ("id.ray_backward", "id.step"),
           ("id.adam", "id.step")},
}
ROOTS = {"pose": ("pose.estimate", 1), "train": ("train.step", 1),
         "id": ("id.image_loss", N_IMAGES)}
LABELS = {"train": ["forward", "backward", "adam"],
          "id": ["ray_features", "image_losses", "ray_backward", "adam"]}


def _field():
    cfg = FieldConfig(grid_size=(10, 10, 10), density_n_comp=(2, 2, 2),
                      app_n_comp=(3, 3, 3), shading_mode="Ref", view_pe=2,
                      fea_pe=2, pos_pe=2, feature_c=8, density_shift=-1.0)
    params = init_field(torch.Generator().manual_seed(0), cfg)
    vol = torch.as_tensor(
        np.random.default_rng(0).random((8, 8, 8)) < 0.5, dtype=torch.float32)
    return cfg, params, make_alpha_mask(vol, cfg.aabb_np)


def _rays(n=24, seed=1):
    """Rays from a sphere of radius 4 towards points near the origin."""
    g = torch.Generator().manual_seed(seed)
    o = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1)
    d = torch.nn.functional.normalize(
        0.3 * torch.randn(n, 3, generator=g) - o, dim=-1)
    return torch.cat([4.0 * o, d], dim=-1)


def _id_setup():
    cfg = IDConfig(backbone=ViTConfig(dim=32, depth=1, num_heads=2,
                                      mlp_ratio=2), ray_feature_c=16)
    params = init_id_module(torch.Generator().manual_seed(2), cfg, CPU)
    g = torch.Generator().manual_seed(3)
    ori = torch.randn(64, 3, generator=g)
    dirs = torch.nn.functional.normalize(torch.randn(64, 3, generator=g),
                                         dim=-1)
    rgb = torch.rand(64, 3, generator=g)
    imgs = torch.rand(N_IMAGES, 40, 48, 4, generator=g)
    return cfg, params, (ori, dirs, rgb), imgs


def _unit(kind):
    """-> a call that runs one unit of ``kind``, taking an optional
    ``mark``."""
    if kind == "pose":
        cfg, params, (ori, dirs, rgb), imgs = _id_setup()
        bank = ray_bank(params, cfg, ori, dirs, rgb, device=CPU)
        up = torch.tensor([0.0, 0.0, 1.0])
        img, mask = blend_batch(imgs[:1])

        def run(mark=None):
            estimate_pose_single_banked(params, cfg, img[0], mask[0], bank,
                                        ori, dirs, up, k=5, device=CPU)
        return run
    if kind == "train":
        cfg, params, mask = _field()
        params = trainable(params, CPU)
        opt = make_optimizer(params, 0.02, 1e-3, 1.0)
        rays = _rays()
        rgbs = torch.rand(rays.shape[0], 3)
        jitter = torch.rand(rays.shape[0], 1)
        weights = {"l1": 1e-4, "tv_d": 0.0, "tv_a": 0.0}

        def run(mark=None):
            train_step(cfg, params, opt, mask, rays, rgbs, torch.ones(3),
                       weights, mark=mark, n_samples=16, jitter=jitter,
                       use_l1=True)
        return run
    cfg, params, (ori, dirs, rgb), imgs = _id_setup()
    params = trainable(params, CPU)
    opt = make_id_optimizer(params)
    blended, masks = blend_batch(imgs)
    poses = torch.eye(4).repeat(N_IMAGES, 1, 1)
    poses[:, 2, 3] = 4.0

    def run(mark=None):
        id_train_step(params, opt, blended, masks, poses, ori, -dirs, rgb,
                      cfg, N_IMAGES, mark=mark)
    return run


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof.events()


def _edges(events):
    """(span, its nearest enclosing program span) of every program span."""
    out = []
    for e in events:
        if e.name not in NAMES:
            continue
        parent = e.cpu_parent
        while parent is not None and parent.name not in NAMES:
            parent = parent.cpu_parent
        out.append((e.name, None if parent is None else parent.name))
    return out


@pytest.fixture
def entered(monkeypatch):
    """The names of the ``record_function`` ranges entered, in order."""
    names = []

    class Counting(torch.profiler.record_function):
        def __enter__(self):
            names.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    return names


def _torch_own(name):
    """torch.optim's ranges, which it enters with or without a profiler."""
    return name.startswith("Optimizer.")


@pytest.mark.parametrize("kind", sorted(EDGES))
def test_a_unit_emits_its_spans_nested(kind, entered):
    run = _unit(kind)
    tracing.reset_counters()
    edges = _edges(_profiled(run))
    assert set(edges) == EDGES[kind]
    root, n = ROOTS[kind]
    assert sum(1 for name, _ in edges if name == root) == n
    assert all(name in NAMES or _torch_own(name) for name in entered)
    tracing.reset_counters()


def test_span_names_are_unique_and_described():
    for table in (tracing.SPANS, tracing.COUNTERS):
        names = [name for name, _ in table]
        assert len(set(names)) == len(names)
        assert all(doc and "." in name for name, doc in table)


@pytest.mark.parametrize("kind", sorted(EDGES))
def test_no_profiler_enters_no_record_function(kind, entered):
    run = _unit(kind)
    tracing.reset_counters()
    run()
    assert [name for name in entered if not _torch_own(name)] == []
    assert tracing.counters() == {}
    assert not torch.autograd.profiler._is_profiler_enabled
    assert tracing.span("pose.estimate") is tracing.span("train.step")


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("profiled", [False, True])
def test_count_issues_an_op_only_under_a_profiler(profiled):
    mask = torch.rand(5, 7) > 0.5
    tracing.reset_counters()
    ops = _Ops()

    def counted():
        with ops:
            tracing.count("render.live_samples", mask)
        tracing.count("render.samples", mask.numel())

    if profiled:
        _profiled(counted)
        assert ops.ops
        assert tracing.counters() == {"render.live_samples": float(mask.sum()),
                                      "render.samples": 35.0}
    else:
        counted()
        assert ops.ops == [] and tracing.counters() == {}
    tracing.reset_counters()


def test_render_counters_match_the_masks():
    cfg, params, mask = _field()
    rays = _rays(seed=5)
    jitter = torch.rand(rays.shape[0], 1, generator=torch.Generator()
                        .manual_seed(6))
    tracing.reset_counters()
    for _ in range(2):  # totals add up, and reading them keeps them
        _profiled(lambda: render_rays(cfg, params, mask, rays,
                                      jitter=jitter, is_train=True,
                                      n_samples=16))
        got = tracing.counters()
    # the masks, worked out from the sampler, the mask and the march
    xyz, z_vals, valid = sample_ray(cfg, rays[:, :3], rays[:, 3:6],
                                    jitter=jitter, n_samples=16)
    valid = valid & (sample_alpha(mask, xyz) > 0)
    sigma_feature, _ = compute_features(cfg, params,
                                        normalize_coord(cfg, xyz))
    sigma = torch.where(valid, feature2density(cfg, sigma_feature), 0.0)
    dists = torch.cat([z_vals[:, 1:] - z_vals[:, :-1],
                       torch.zeros_like(z_vals[:, :1])], dim=-1)
    _, weight, _ = raw2alpha(sigma, dists * cfg.distance_scale)
    app = weight > cfg.ray_march_weight_thres
    assert 0 < int(app.sum()) < int(valid.sum()) < valid.numel()
    assert got == {"render.samples": 2.0 * valid.numel(),
                   "render.live_samples": 2.0 * float(valid.sum()),
                   "render.app_samples": 2.0 * float(app.sum())}
    tracing.reset_counters()
    assert tracing.counters() == {}


@pytest.mark.parametrize("profiled", [False, True])
@pytest.mark.parametrize("kind", sorted(LABELS))
def test_marks_keep_their_labels_and_order(kind, profiled):
    run = _unit(kind)
    marks = []
    if profiled:
        _profiled(lambda: run(mark=marks.append))
    else:
        run(mark=marks.append)
    assert marks == LABELS[kind]
    tracing.reset_counters()
