"""The port's quantized generation against the JAX package's (CPU).

Greedy decoding with the same quantized weights must give the JAX package's
tokens exactly: W8 weights, the int8 and int4 caches and, on the CPU, W4
weights through the bf16-dequantized matmul run the same arithmetic in both
packages (JAX with use_flash=False).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import decode as jdec
from controlar_tpu import generate as jgen
from controlar_tpu import quant as jquant
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu.pipeline import ControlARPipeline as JPipeline
from controlar_tpu_torch import convert
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu.config import GPTConfig, VQConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.pipeline import ControlARPipeline as TPipeline


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def _cfg_pair(model_type="c2i", **over):
    kw = dict(model_type=model_type, dim=256, n_layer=3, n_head=4, vocab_size=96,
              num_classes=10, caption_dim=24, cls_token_num=1 if model_type == "c2i" else 6,
              block_size=16)
    kw.update(over)
    return GPTConfig(**kw), TGPTConfig(**kw)


def _params(cfg):
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)
    # the t2i head is zero at init; give it weights so greedy tokens vary
    params["output"] = jax.random.normal(jax.random.PRNGKey(1), params["output"].shape) * 0.5
    return params


def _conditioning(model_type, b, cfg):
    rng = np.random.default_rng(4)
    kw = {"adapter_features": rng.standard_normal((b, cfg.block_size, 384)).astype(np.float32)}
    if model_type == "c2i":
        kw["labels"] = np.arange(b, dtype=np.int32) * 3 % cfg.num_classes
    else:
        kw["caption_emb"] = rng.standard_normal((b, cfg.cls_token_num, cfg.caption_dim)
                                                ).astype(np.float32)
        lens = np.array([2, 6, 4])[:b]
        kw["emb_masks"] = (np.arange(cfg.cls_token_num)[None, :]
                           >= (cfg.cls_token_num - lens)[:, None]).astype(np.int32)
    return kw


def _quantized_pair(mode, model_type):
    cfg, tcfg = _cfg_pair(model_type)
    params = _params(cfg)
    if mode == "w8":
        jq = jquant.quantize_gpt_params(params)
    else:
        jq = jquant.quantize_gpt_params_w4(jdec.unstack_layers(params), cfg=cfg)
    return cfg, jq, tcfg, convert.gpt_from_jax(_np_tree(jq), tcfg)


GREEDY_CASES = {  # weights, model type, JAX cache dtype, the port's
    "c2i_w8_kv8": ("w8", "c2i", jnp.int8, torch.int8),
    "t2i_w8_kv8_emb_masks": ("w8", "t2i", jnp.int8, torch.int8),
    "c2i_w4split_kv4": ("w4", "c2i", jnp.int4, "int4"),
}


@pytest.mark.parametrize("case", list(GREEDY_CASES))
def test_greedy_tokens_match_jax(case):
    mode, model_type, jdt, tdt = GREEDY_CASES[case]
    cfg, jq, tcfg, model = _quantized_pair(mode, model_type)
    cond = _conditioning(model_type, 3, cfg)
    opts = dict(max_new_tokens=cfg.block_size, sample_logits=False, top_k=20,
                control_strength=0.8, cfg_scale=4.0)
    want = jgen.generate(jq, cfg, **{k: jnp.asarray(v) for k, v in cond.items()},
                         cache_dtype=jdt, use_flash=False, **opts)
    got = tgen.generate(model, tcfg, **{k: torch.from_numpy(v) for k, v in cond.items()},
                        cache_dtype=tdt, device="cpu", **opts)
    assert got.shape == (3, cfg.block_size)
    assert len(np.unique(np.asarray(want))) > 4  # a real token stream, not one id
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("case", ["c2i_w8_kv8", "c2i_w4split_kv4"])
def test_flash_path_plain_versions_keep_the_tokens(case):
    """use_flash=True on the CPU: the q8/q4 kernels' plain versions on the
    256-row cache against the JAX package's masked attention over the
    dequantized slab. The plain versions fold the scales in after the dot
    products, so logits differ in the last bits, and greedy tokens agree."""
    mode, model_type, jdt, tdt = GREEDY_CASES[case]
    cfg, jq, tcfg, model = _quantized_pair(mode, model_type)
    cond = _conditioning(model_type, 3, cfg)
    opts = dict(max_new_tokens=cfg.block_size, sample_logits=False, cfg_scale=4.0)
    want = jgen.generate(jq, cfg, **{k: jnp.asarray(v) for k, v in cond.items()},
                         cache_dtype=jdt, use_flash=False, **opts)
    got = tgen.generate(model, tcfg, **{k: torch.from_numpy(v) for k, v in cond.items()},
                        cache_dtype=tdt, use_flash=True, device="cpu", **opts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pipeline_with_quantized_cache_matches_jax():
    """Canny -> adapter -> W8 + int8-cache tokens -> VQ. top_k=1 makes
    sampling deterministic in both packages; images agree within one step."""
    img = 32
    cfg, tcfg = _cfg_pair("c2i", dim=64, n_layer=3, block_size=(img // 16) ** 2)
    jq = jquant.quantize_gpt_params(_params(cfg))
    model = convert.gpt_from_jax(_np_tree(jq), tcfg)
    vq_kw = dict(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16)
    ad_cfg = jvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=2,
                            layerscale=True)
    vq_params = jvq.init_vq_params(jax.random.PRNGKey(2), VQConfig(**vq_kw))
    ad_params = jvit.init_vit_params(jax.random.PRNGKey(3), ad_cfg)
    jpipe = JPipeline(gpt_cfg=cfg, gpt_params=jq, vq_cfg=VQConfig(**vq_kw),
                      vq_params=vq_params, adapter_cfg=ad_cfg, adapter_params=ad_params)
    tad_cfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=2,
                             layerscale=True)
    tpipe = TPipeline(gpt_cfg=tcfg, gpt=model, vq_cfg=TVQConfig(**vq_kw),
                      vq=convert.vq_from_jax(_np_tree(vq_params), TVQConfig(**vq_kw)),
                      adapter_cfg=tad_cfg,
                      adapter=convert.vit_from_jax(_np_tree(ad_params), tad_cfg),
                      device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, img, img, 3)).astype(np.uint8)
    labels = np.array([3, 7])
    want = jpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1,
                          cache_dtype=jnp.int8)
    got = tpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1,
                         cache_dtype=torch.int8)
    assert got.shape == (2, img, img, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
