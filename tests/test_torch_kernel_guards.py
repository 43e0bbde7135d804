"""What the kernel wrappers refuse, and where their callers send what they
refuse, on the CPU: the guard that keeps a CUDA launch from running under
autograd (the scoring kernels have no backward), and the shape predicates of
the two scoring kernels, which send a shape the kernel does not take to
the exact torch path, as the JAX package falls back to XLA. The card's
side of both is in tests/test_torch_cuda_kernels.py.
"""

import numpy as np
import pytest
import torch

from iffnerf_tpu_torch.ops import _build
from iffnerf_tpu_torch.ops import banked_attention as banked
from iffnerf_tpu_torch.ops import fused_ray_attention as fused
from iffnerf_tpu_torch.ops.gather import gather_rows
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose import solve as tsolve
from iffnerf_tpu_torch.pose.vit import ViTConfig

from torch_parity import blob_mask, replace


def test_refuse_grad_raises_only_when_autograd_would_track():
    w = torch.ones(3, requires_grad=True)
    plain = torch.ones(3)
    with pytest.raises(RuntimeError, match="no backward on CUDA"):
        _build.refuse_grad("k", (plain, w))
    _build.refuse_grad("k", (plain, None))
    with torch.no_grad():
        _build.refuse_grad("k", (plain, w))


def test_plain_versions_stay_differentiable_on_the_cpu():
    g = torch.Generator().manual_seed(0)
    bank = torch.randn((70, 32), generator=g, requires_grad=True)
    q = torch.randn((256, 32), generator=g)
    valid = torch.zeros(256, dtype=torch.bool)
    valid[10:100] = True
    banked.banked_scores_fused(bank, q, valid)[:5].sum().backward()
    assert bank.grad is not None and bool(bank.grad.abs().sum() > 0)
    table = torch.randn((9, 4), generator=g, requires_grad=True)
    gather_rows(table, torch.tensor([1, 1, 8], dtype=torch.int32)).sum().backward()
    assert table.grad[1].tolist() == [2.0] * 4 and table.grad[0].abs().sum() == 0


@pytest.mark.parametrize("dtype,p,d,takes", [
    (torch.float32, 256, 384, True), (torch.float32, 256, 32, True),
    (torch.float32, 256, 96, True), (torch.float32, 256, 48, False),
    (torch.float32, 256, 16, False), (torch.float32, 256, 416, False),
    (torch.float32, 64, 384, False),
    (torch.bfloat16, 256, 384, True), (torch.bfloat16, 256, 64, True),
    (torch.bfloat16, 256, 96, False), (torch.bfloat16, 256, 448, False),
    (torch.bfloat16, 64, 384, False), (torch.float16, 256, 384, False),
])
def test_banked_kernel_takes(dtype, p, d, takes):
    """256 patches; depth a multiple of 32 (float32) or 64 (bfloat16) up
    to 384."""
    assert banked.kernel_takes(dtype, p, d) is takes


@pytest.mark.parametrize("dtype,p,widths,takes", [
    (torch.float32, 256, (141, 256, 256, 256, 384), True),
    (torch.bfloat16, 256, (141, 256, 256, 256, 384), True),
    (torch.float32, 64, (141, 256, 256, 256, 384), False),
    (torch.bfloat16, 256, (141, 256, 256, 256, 640), False),
    (torch.bfloat16, 256, (141, 192, 256, 256, 384), False),
    (torch.float32, 256, (141, 192, 256, 256, 384), False),
    (torch.float32, 256, (141, 128, 128, 128, 384), True),
    (torch.float32, 256, (141, 256, 256, 256, 512), False),
    (torch.float32, 256, (1000, 256, 256, 256, 384), False),
    (torch.float16, 256, (141, 256, 256, 256, 384), False),
])
def test_fused_kernel_takes(dtype, p, widths, takes):
    """256 patches; bf16 widths from BF16_WIDTHS; float32 widths from
    F32_WIDTHS whose activations leave two ring stages of shared memory
    (an input of 1000 does not)."""
    assert fused.kernel_takes(dtype, p, widths) is takes


@pytest.fixture(scope="module")
def small_crop():
    """A 112 crop: 8 x 8 = 64 patches, which neither kernel takes."""
    cfg = tid.IDConfig(resize_size=128, crop_size=112,
                       backbone=ViTConfig(img_size=112, depth=1))
    params = tid.init_id_module(torch.Generator().manual_seed(3), cfg,
                                device="cpu")
    rng = np.random.default_rng(3)
    n = 300
    d = rng.standard_normal((n, 3)).astype(np.float32)
    rays = (torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
            torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True)),
            torch.from_numpy(rng.random((n, 3), dtype=np.float32)))
    img = torch.from_numpy(rng.random((96, 96, 3), dtype=np.float32))
    mask = torch.from_numpy(blob_mask(96, 96))
    return cfg, params, rays, img, mask


def test_score_rays_sends_a_refused_bank_to_the_exact_path(small_crop):
    cfg, params, rays, img, mask = small_crop
    q, pv, _ = tid.image_queries(params, cfg, img, mask)
    assert q.shape[0] == 64
    bank = tid.ray_bank(params, cfg, *rays, device="cpu")
    scores, att = tid.score_rays(params, cfg, q, pv, *rays, bank=bank)
    exact, att_exact = tid.score_rays(params, replace(cfg, fused_bank=False),
                                      q, pv, *rays, bank=bank)
    assert att is not None and att_exact is not None
    assert torch.equal(scores, exact)


def test_fused_scoring_sends_a_refused_shape_to_the_plain_chain(small_crop,
                                                               monkeypatch):
    cfg, params, rays, img, mask = small_crop

    def never(*a):
        raise AssertionError("the fused kernel's wrapper was called")

    monkeypatch.setattr(fused, "fused_ray_scores", never)
    got = tsolve._scores_maybe_fused(
        params, replace(cfg, fused_scoring=True), img, mask, *rays)
    want = tsolve._scores_maybe_fused(params, cfg, img, mask, *rays)
    assert torch.equal(got, want)
