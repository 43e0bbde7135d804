"""Port parity for the image side: the ViT backbone, image and mask
preprocessing, and the patch position encoding, against the JAX package on
the CPU. Inputs come from numpy seeds."""

import numpy as np
import jax.numpy as jnp
import pytest

from iffnerf_tpu.pose import id_module as jid
from iffnerf_tpu.pose.vit import ViTConfig as JViTConfig
from iffnerf_tpu.pose.vit import vit_forward_features as jvit
from iffnerf_tpu_torch.pose import id_module as tid
from iffnerf_tpu_torch.pose.vit import ViTConfig as TViTConfig
from iffnerf_tpu_torch.pose.vit import vit_forward_features as tvit

from torch_parity import blob_mask, configs, f32, params, t

SHAPES = [(96, 96), (417, 612), (800, 800)]


def test_vit_matches_depth1_dim384():
    jcfg, _ = configs()
    jp, tp = params(7, jcfg)
    img = np.random.default_rng(7).standard_normal((224, 224, 3)).astype(np.float32)
    want = jvit(jp["backbone"], jnp.asarray(img), JViTConfig(depth=1))
    got = tvit(tp["backbone"], t(img), TViTConfig(depth=1))
    assert got.shape == (256, 384)
    # float32 matmuls summed in another order, then LayerNorm: 1e-5
    np.testing.assert_allclose(f32(got), f32(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("hw", SHAPES)
def test_preprocess_image_matches(hw):
    img = np.random.default_rng(sum(hw)).random((*hw, 3), dtype=np.float32)
    want = jid.preprocess_image(jid.IDConfig(), jnp.asarray(img))
    got = tid.preprocess_image(tid.IDConfig(), t(img))
    assert got.shape == (224, 224, 3)
    # antialiased resizes agree to 5e-7; the ImageNet std (~0.22) scales
    # that to ~2e-6
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1e-5)


def _jax_mask_coverage(cfg, mask):
    """JAX's preprocess_mask before the threshold."""
    m = jnp.asarray(mask, jnp.float32)[..., None]
    nh, nw = jid._short_side_resize_shape(*mask.shape, cfg.resize_size)
    m = jid._resize(m, nh, nw, "linear")
    top = jid._center_crop_origin(nh, cfg.crop_size)
    left = jid._center_crop_origin(nw, cfg.crop_size)
    m = m[top:top + cfg.crop_size, left:left + cfg.crop_size]
    g = cfg.backbone.grid
    return np.asarray(jid._resize(m, g, g, "linear"))[..., 0].reshape(-1)


@pytest.mark.parametrize("hw", SHAPES)
def test_preprocess_mask_matches(hw):
    mask = blob_mask(*hw)
    jcfg = jid.IDConfig()
    want = np.asarray(jid.preprocess_mask(jcfg, jnp.asarray(mask)))
    got = tid.preprocess_mask(tid.IDConfig(), t(mask)).numpy()
    cov = _jax_mask_coverage(jcfg, mask)
    np.testing.assert_array_equal(cov > jcfg.mask_threshold, want)
    # patches within resample tolerance of the 0.1 threshold may flip;
    # every other patch agrees exactly
    decided = np.abs(cov - jcfg.mask_threshold) > 1e-4
    assert decided.mean() > 0.95
    assert 0 < want.sum() < want.size
    np.testing.assert_array_equal(got[decided], want[decided])


def test_img_position_encoding_matches():
    want = jid.img_position_encoding(jid.IDConfig())
    got = tid.img_position_encoding(tid.IDConfig())
    assert got.shape == (256, 14)
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=1e-7)
