"""The VQ encoder, quantizer and encode of the port against the JAX
package's `models/vq.py`, fp32 on the CPU, with the weights carried over by
`convert.vq_from_jax`.

Tolerance 1e-4 absolute (fp32 on both sides, convolutions and norms summed
in another order). The nearest-code argmin can flip on a tie: where the
indices differ, the two codes' distances must agree within 1e-5 (fp32
distances of unit vectors, values in [0, 4]).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu.config import VQConfig
from controlar_tpu.models import vq as jvq
from controlar_tpu_torch import convert
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import vq as tvq

ATOL = 1e-4
TIE = 1e-5
# two tokenizers: VQ-8-like (three levels, attention at the last), and
# VQ-16-like (four levels, the VQ-16 channel multipliers' shape)
CONFIGS = {
    "three_levels": dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16,
                         encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2)),
    "four_levels": dict(codebook_size=128, codebook_embed_dim=8, z_channels=32, ch=32,
                        encoder_ch_mult=(1, 1, 2, 4), decoder_ch_mult=(1, 1, 2, 4),
                        num_res_blocks=1),
}


def _random_params(cfg, seed):
    """The JAX package's VQ tree (its structure from `init_vq_params`,
    traced, not run) filled from numpy: convolutions uniform in
    +-1/sqrt(fan_in), norms near one and zero, a random codebook."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jvq.init_vq_params(jax.random.PRNGKey(0), cfg))

    def fill(path, s):
        leaf = path[-1].key if hasattr(path[-1], "key") else None
        if leaf == "w":
            bound = 1 / np.sqrt(np.prod(s.shape[:3]))
            return rng.uniform(-bound, bound, s.shape).astype(np.float32)
        if leaf == "scale":
            return (1 + 0.05 * rng.standard_normal(s.shape)).astype(np.float32)
        return (0.05 * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(fill, shapes)
    params["codebook"] = rng.standard_normal(shapes["codebook"].shape).astype(np.float32)
    return params


@functools.lru_cache(maxsize=None)
def _pair_cached(name, l2=True, seed=0):
    kw = dict(CONFIGS[name], codebook_l2_norm=l2)
    cfg = VQConfig(**kw)
    params = _random_params(cfg, seed)
    model = convert.vq_from_jax(params, TVQConfig(**kw))
    return cfg, TVQConfig(**kw), jax.tree.map(jnp.asarray, params), model


def _pair(name, codebook_l2_norm=True):
    return _pair_cached(name, codebook_l2_norm)


def _jit(fn, cfg):
    """fn(params, cfg, x) compiled once for the configuration."""
    return jax.jit(lambda p, x: fn(p, cfg, x))


def _images(b, h, w, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (b, h, w, 3)).astype(np.float32)


def _check_indices(got, want, z, emb, l2=True):
    """Indices equal, or ties: the codes' distances to z (normalised when
    l2) within TIE. Returns the number of ties."""
    differ = got != want
    if differ.any():
        zn = z[differ]
        if l2:
            zn = zn / np.linalg.norm(zn, axis=-1, keepdims=True)
        d = (zn * zn).sum(-1, keepdims=True) + (emb * emb).sum(-1) - 2 * zn @ emb.T
        rows = np.arange(len(zn))
        gap = np.abs(d[rows, got[differ]] - d[rows, want[differ]])
        assert gap.max() <= TIE, gap
    return int(differ.sum())


def test_vq_from_jax_reads_the_encoder():
    cfg, tcfg, params, model = _pair("three_levels")
    sd = model.state_dict()
    np.testing.assert_array_equal(sd["quant_conv.weight"].permute(2, 3, 1, 0).numpy(),
                                  np.asarray(params["quant_conv"]["w"]))
    np.testing.assert_array_equal(
        sd["encoder.levels.1.downsample.conv.bias"].numpy(),
        np.asarray(params["encoder"]["levels"][1]["downsample"]["conv"]["b"]))
    assert sum(k.startswith("encoder.") for k in sd) == len(jax.tree.leaves(params["encoder"]))


@pytest.mark.parametrize("hw", [(16, 16), (24, 40)])
def test_downsample(hw):
    cfg, tcfg, params, model = _pair("three_levels")
    x = np.random.default_rng(2).standard_normal((2, *hw, 16)).astype(np.float32)
    want = jvq.downsample(params["encoder"]["levels"][0]["downsample"], jnp.asarray(x))
    got = tvq.downsample(model.encoder.levels[0].downsample, torch.from_numpy(x))
    assert got.shape == want.shape == (2, hw[0] // 2, hw[1] // 2, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_forward(name):
    cfg, tcfg, params, model = _pair(name)
    x = _images(2, 32, 48)
    want = _jit(jvq.encoder_forward, cfg)(params["encoder"], jnp.asarray(x))
    got = tvq.encoder_forward(model.encoder, tcfg, torch.from_numpy(x))
    f = 2 ** (len(cfg.encoder_ch_mult) - 1)
    assert got.shape == want.shape == (2, 32 // f, 48 // f, cfg.z_channels)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("l2", [True, False])
def test_quantize(l2):
    cfg, tcfg, params, model = _pair("three_levels", codebook_l2_norm=l2)
    z = np.random.default_rng(3).standard_normal((2, 5, 7, 8)).astype(np.float32)
    jz, jidx = jvq.quantize(params, cfg, jnp.asarray(z))
    tz, tidx = tvq.quantize(model, tcfg, torch.from_numpy(z))
    assert tidx.shape == (2, 5, 7) and tz.shape == z.shape
    _check_indices(tidx.numpy(), np.asarray(jidx), z, np.asarray(jvq._codebook(params, cfg)),
                   l2)
    same = tidx.numpy() == np.asarray(jidx)
    np.testing.assert_allclose(tz.numpy()[same], np.asarray(jz)[same], atol=1e-6)


def test_quantize_straight_through_gradient():
    """The gradient reaches z through the (normalised) z, as the JAX
    package's stop_gradient makes it."""
    cfg, tcfg, params, model = _pair("three_levels")
    rng = np.random.default_rng(4)
    z = rng.standard_normal((1, 3, 4, 8)).astype(np.float32)
    w = rng.standard_normal((1, 3, 4, 8)).astype(np.float32)
    want = jax.grad(lambda zz: jnp.sum(jvq.quantize(params, cfg, zz)[0] * w))(jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    (tvq.quantize(model, tcfg, zt)[0] * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_and_decode_code(name):
    cfg, tcfg, params, model = _pair(name)
    x = _images(2, 32, 32, seed=5)
    jzq, jidx = _jit(jvq.encode, cfg)(params, jnp.asarray(x))
    tzq, tidx = tvq.encode(model, tcfg, torch.from_numpy(x), device="cpu")
    h = jvq.conv2d(_jit(jvq.encoder_forward, cfg)(params["encoder"], jnp.asarray(x)),
                   params["quant_conv"]["w"], params["quant_conv"]["b"])
    _check_indices(tidx.numpy(), np.asarray(jidx), np.asarray(h),
                   np.asarray(jvq._codebook(params, cfg)))
    same = tidx.numpy() == np.asarray(jidx)
    np.testing.assert_allclose(tzq.detach().numpy()[same], np.asarray(jzq)[same], atol=ATOL)
    # decode_code(encode(x)) on the JAX package's indices, so a tie does not
    # change the image compared
    want = _jit(jvq.decode_code, cfg)(params, jidx)
    got = tvq.decode_code(model, tcfg, torch.from_numpy(np.array(jidx)))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_init_vq_draws_the_decoder_first():
    """A seed gives the decoding half it gave before the encoder was ported:
    its draws come first, in module order, then the codebook."""
    tcfg = TVQConfig(**CONFIGS["three_levels"])
    sd = tvq.init_vq(tcfg, seed=3).state_dict()
    gen = torch.Generator().manual_seed(3)
    conv = sd["post_quant_conv.weight"]
    bound = 1.0 / np.sqrt(conv[0].numel())
    want = (torch.rand(conv.shape, generator=gen) * 2 - 1) * bound
    assert torch.equal(conv, want)
