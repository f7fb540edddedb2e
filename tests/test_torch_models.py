"""The port's models against the JAX package's, fp32 on the CPU, with the
weights carried over by `controlar_tpu_torch.convert`.

Tolerance 1e-4 absolute: fp32 on both sides, with matmuls and reductions
summed in another order over a few layers.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu.config import GPTConfig, VQConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu_torch import convert
from controlar_tpu_torch import decode as tdec
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tvit_cfg(cfg):
    return tvit.ViTConfig(**{f: getattr(cfg, f) for f in
                             ("hidden_size", "n_layer", "n_head", "mlp_ratio", "patch_size",
                              "pos_grid", "layerscale", "layer_norm_eps")})


@pytest.mark.parametrize("hw", [(56, 56), (84, 70)])  # native 4x4 grid; interpolated 6x5
def test_vit_forward(hw):
    cfg = jvit.ViTConfig(hidden_size=64, n_layer=2, n_head=4, patch_size=14, pos_grid=4,
                         layerscale=True)
    params = jvit.init_vit_params(jax.random.PRNGKey(0), cfg)
    # non-trivial norms, biases and layer scales
    params = jax.tree.map(
        lambda a: a + 0.1 * jax.random.normal(jax.random.PRNGKey(a.size), a.shape), params)
    x = np.random.default_rng(0).standard_normal((2, *hw, 3)).astype(np.float32)
    want = jvit.vit_forward(params, cfg, jnp.asarray(x))
    model = convert.vit_from_jax(_np_tree(params), _tvit_cfg(cfg))
    got = tvit.vit_forward(model, _tvit_cfg(cfg), torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_vq_decode_code():
    kw = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16,
              encoder_ch_mult=(1, 2, 2), decoder_ch_mult=(1, 2, 2))
    cfg = VQConfig(**kw)
    params = jvq.init_vq_params(jax.random.PRNGKey(1), cfg)
    idx = np.random.default_rng(1).integers(0, 64, (2, 3, 5)).astype(np.int32)
    want = jvq.decode_code(params, cfg, jnp.asarray(idx))
    model = convert.vq_from_jax(_np_tree(params), TVQConfig(**kw))
    got = tvq.decode_code(model, TVQConfig(**kw), torch.from_numpy(idx))
    assert got.shape == (2, 12, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _gpt_pair(model_type, seed=0, **over):
    kw = dict(model_type=model_type, dim=64, n_layer=6, n_head=4, vocab_size=96,
              num_classes=10, caption_dim=24, adapter_size="small",
              cls_token_num=1 if model_type == "c2i" else 6, block_size=16)
    kw.update(over)
    cfg = GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(seed), cfg)
    # the t2i head is zero at init; give it weights so logits mean something
    params["output"] = jax.random.normal(jax.random.PRNGKey(seed + 1), params["output"].shape)
    model = convert.gpt_from_jax(_np_tree(params), TGPTConfig(**kw))
    return cfg, TGPTConfig(**kw), params, model


@pytest.mark.parametrize("model_type", ["c2i", "t2i"])
def test_prefill_and_decode_steps(model_type):
    cfg, tcfg, params, model = _gpt_pair(model_type)
    rng = np.random.default_rng(2)
    b, t = 3, cfg.cls_token_num
    prefix = rng.standard_normal((b, t, cfg.dim)).astype(np.float32)
    fused3 = rng.standard_normal((3, b, cfg.block_size, cfg.dim)).astype(np.float32) * 0.5
    col_mask = None
    if model_type == "t2i":
        col_mask = np.arange(t)[None, :] >= np.array([0, 2, 5])[:, None]  # left padding
    s_max = 24

    jc = jdec.init_flat_caches(cfg, b, s_max, jnp.float32)
    jl, jc = jdec.prefill_flat(params, cfg, jc, jnp.asarray(prefix), jnp.asarray(fused3),
                               None if col_mask is None else jnp.asarray(col_mask), 0.7)
    tc = tdec.init_flat_caches(tcfg, b, s_max, torch.float32)
    tl, tc = tdec.prefill_flat(model, tcfg, tc, torch.from_numpy(prefix),
                               torch.from_numpy(fused3),
                               None if col_mask is None else torch.from_numpy(col_mask), 0.7)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for l in range(cfg.n_layer):
        np.testing.assert_allclose(tc[l].numpy(), np.asarray(jc[l]), atol=ATOL)

    col_full = None
    if col_mask is not None:
        col_full = np.concatenate([col_mask, np.ones((b, s_max - t), bool)], axis=1)
    for i in range(3):
        tok = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
        pos = t + i
        jl, jc = jdec.decode_step_flat(
            params, cfg, jc, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(fused3),
            None if col_full is None else jnp.asarray(col_full), 0.7, use_flash=False)
        tl, tc = tdec.decode_step_flat(
            model, tcfg, tc, torch.from_numpy(tok).long(), pos, torch.from_numpy(fused3),
            None if col_full is None else torch.from_numpy(col_full), 0.7, use_flash=False)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    for l in range(cfg.n_layer):
        np.testing.assert_allclose(tc[l].numpy(), np.asarray(jc[l]), atol=ATOL)


def test_control_tokens_and_fusion_projections():
    cfg, tcfg, params, model = _gpt_pair("c2i")
    feats = np.random.default_rng(3).standard_normal((2, 16, 384)).astype(np.float32)
    drop = np.array([False, True])
    want = jgpt.fusion_projections(
        params, jgpt.control_tokens(params, cfg, jnp.asarray(feats), jnp.asarray(drop)))
    got = tgpt.fusion_projections(
        model, tgpt.control_tokens(model, tcfg, torch.from_numpy(feats), torch.from_numpy(drop)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_array_equal(tgpt._fusion_gates(tcfg)[0], jgpt._fusion_gates(cfg)[0])
    np.testing.assert_array_equal(tgpt._fusion_gates(tcfg)[1], jgpt._fusion_gates(cfg)[1])


@pytest.mark.parametrize("model_type", ["c2i", "t2i"])
def test_random_init_matches_jax_distribution(model_type):
    """init_gpt draws from the JAX init's distribution: the same shapes, and
    the same fixed values (norms, zero t2i head) and scales."""
    cfg, tcfg, params, _ = _gpt_pair(model_type)
    ref = convert.gpt_from_jax(_np_tree(jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)), tcfg)
    model = tgpt.init_gpt(tcfg, seed=0)
    ref_sd, sd = ref.state_dict(), model.state_dict()
    assert ref_sd.keys() == sd.keys()
    for k in sd:
        assert sd[k].shape == ref_sd[k].shape, k
        if k.endswith("norm") or (k == "output.weight" and model_type == "t2i"):
            torch.testing.assert_close(sd[k], ref_sd[k])
        else:
            assert abs(sd[k].std().item() / ref_sd[k].std().item() - 1) < 0.2, k
