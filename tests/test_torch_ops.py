"""The port's ops against the JAX package's, on the same numpy inputs (CPU)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu.ops import canny as jcanny
from controlar_tpu.ops import conv as jconv
from controlar_tpu.ops import norms as jnorms
from controlar_tpu.ops import resize as jresize
from controlar_tpu.ops import rope as jrope
from controlar_tpu.ops import sampling as jsampling
from controlar_tpu_torch.ops import canny as tcanny
from controlar_tpu_torch.ops import conv as tconv
from controlar_tpu_torch.ops import norms as tnorms
from controlar_tpu_torch.ops import resize as tresize
from controlar_tpu_torch.ops import rope as trope
from controlar_tpu_torch.ops import sampling as tsampling


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# fp32 on both sides; sums taken in another order -> 1e-5
ATOL = 1e-5


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)
    got = tnorms.rms_norm(_t(x), _t(w), 1e-5)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=1e-5)


def test_rms_norm_bf16():
    """bf16 activations: fp32 statistics, cast back, then scaled in bf16; the
    two may differ by one bf16 step (2**-7 relative) after the sums."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    got = tnorms.rms_norm(_t(x).bfloat16(), _t(w).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("c", [16, 64])
def test_group_norm(c):
    rng = np.random.default_rng(c)
    x = rng.standard_normal((2, 6, 5, c)).astype(np.float32) * 2 + 1
    s = rng.standard_normal(c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    want = jnorms.group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    got = tnorms.group_norm(_t(x), _t(s), _t(b))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("grid,hd,cls", [(4, 16, 1), (6, 64, 120), (24, 64, 1)])
def test_rope_table_square(grid, hd, cls):
    want = jrope.precompute_rope_2d(grid, hd, 10000.0, cls)
    got = trope.precompute_rope_2d(grid, hd, 10000.0, cls)
    np.testing.assert_array_equal(got.numpy(), want)


def test_rope_table_rect():
    want = jrope.precompute_rope_2d_rect(3, 5, 32, 10000.0, 7)
    got = trope.precompute_rope_2d_rect(3, 5, 32, 10000.0, 7)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("per_seq", [False, True])
def test_apply_rope(per_seq):
    rng = np.random.default_rng(3)
    table = jrope.precompute_rope_2d(4, 16, 10000.0, 1)  # (17, 8, 2)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    rope = table[None, 3:8].repeat(2, 0) if per_seq else table[3:8]
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(rope))
    got = trope.apply_rope(_t(x), _t(rope))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.8), (40, 0.5), (1, 1.0), (128, 0.95)])
def test_top_k_top_p_filter_survivors(top_k, top_p):
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((4, 128)).astype(np.float32) * 2
    want = np.isfinite(_np(jsampling.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p)))
    got = torch.isfinite(tsampling.top_k_top_p_filter(_t(logits), top_k, top_p)).numpy()
    np.testing.assert_array_equal(got, want)


def test_sample_greedy_and_categorical():
    rng = np.random.default_rng(5)
    logits = _t(rng.standard_normal((6, 50)).astype(np.float32))
    greedy = tsampling.sample_from(logits, None, top_k=10, sample_logits=False)
    np.testing.assert_array_equal(greedy.numpy(), logits.argmax(-1).numpy())
    draws = [tsampling.sample_from(logits, torch.Generator().manual_seed(7), top_k=10)
             for _ in range(2)]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    kth = torch.topk(logits, 10).values[:, -1:]
    assert bool((logits.gather(1, draws[0][:, None]) >= kth).all())


@pytest.mark.parametrize("k,stride,padding", [(3, 1, "SAME"), (1, 1, "SAME"), (4, 4, "VALID")])
def test_conv2d(k, stride, padding):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((2, 8, 12, 5)).astype(np.float32)
    w = rng.standard_normal((k, k, 5, 7)).astype(np.float32) * 0.2  # HWIO
    b = rng.standard_normal(7).astype(np.float32)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride, padding)
    got = tconv.conv2d(_t(x), _t(w.transpose(3, 2, 0, 1)), _t(b), stride, padding)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def test_upsample_nearest2x():
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 5)).astype(np.float32)
    want = jconv.upsample_nearest2x(jnp.asarray(x))
    np.testing.assert_array_equal(tconv.upsample_nearest2x(_t(x)).numpy(), _np(want))


@pytest.mark.parametrize("mode,align", [("nearest", False), ("bilinear", False),
                                        ("bicubic", False), ("bicubic", True)])
@pytest.mark.parametrize("out_hw", [(7, 9), (20, 13)])
def test_resize2d(mode, align, out_hw):
    x = np.random.default_rng(1).standard_normal((2, 11, 10, 3)).astype(np.float32)
    want = jresize.resize2d(jnp.asarray(x), *out_hw, mode=mode, align_corners=align)
    got = tresize.resize2d(_t(x), *out_hw, mode=mode, align_corners=align)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)
    np.testing.assert_array_equal(
        tresize._resize_matrix(11, out_hw[0], mode, align),
        jresize._resize_matrix(11, out_hw[0], mode, align))


@pytest.mark.parametrize("ctype", ["canny", "depth"])
def test_to_patch14(ctype):
    x = np.random.default_rng(2).standard_normal((2, 32, 48, 3)).astype(np.float32)
    want = jresize.to_patch14(jnp.asarray(x), ctype)
    got = tresize.to_patch14(_t(x), ctype)
    assert got.shape == (2, 28, 42, 3)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-5)


def _weak_chain_image():
    """A long vertical edge whose gradient lies between the thresholds, fed
    from a strong stretch at its top, plus a weak diagonal: the hysteresis
    has to grow past max_iters rings along the vertical edge."""
    img = np.zeros((160, 64, 3), np.uint8)
    img[:, 24:] = 30          # |sobel| = 4 * 30 = 120: weak at (100, 200)
    img[:6, 24:] = 120        # strong seed at the top
    for i in range(60):
        img[40 + i, 2 + i // 2: 4 + i // 2, 1] = 35
    return img


@pytest.mark.parametrize("case", ["random_rgb", "random_gray", "weak_chain", "thresholds"])
def test_canny_bit_exact(case):
    rng = np.random.default_rng(11)
    lo, hi = 100, 200
    if case == "random_rgb":
        img = rng.integers(0, 256, (2, 40, 56, 3)).astype(np.uint8)
    elif case == "random_gray":
        img = rng.integers(0, 256, (2, 33, 47)).astype(np.uint8)
    elif case == "weak_chain":
        img = _weak_chain_image()[None]
    else:
        smooth = rng.integers(0, 256, (2, 12, 16, 3)).astype(np.float32)
        img = np.asarray(jresize.resize2d(jnp.asarray(smooth), 48, 64, "bilinear")).astype(np.uint8)
        lo, hi = 20, 60
    want = np.asarray(jcanny.canny(jnp.asarray(img), lo, hi))
    got = tcanny.canny(_t(img), lo, hi).numpy()
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if case == "weak_chain":
        # the chain is longer than max_iters: both stop growing at the bound
        assert 0 < (want[0, :, 23:26] > 0).sum() < 160
