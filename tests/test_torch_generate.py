"""The port's generation loop and pipeline against the JAX package's (CPU).

Greedy decoding must give the JAX package's tokens exactly: both run the
same fp32 weights and bf16 caches through the masked-einsum attention.
Sampled streams cannot match (torch.Generator vs jax.random), so a sampled
run is checked for shape, range and determinism under one seed.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import generate as jgen
from controlar_tpu.config import GPTConfig, VQConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu.pipeline import ControlARPipeline as JPipeline
from controlar_tpu_torch import convert
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.config import GPTConfig as TGPTConfig
from controlar_tpu_torch.config import VQConfig as TVQConfig
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.pipeline import ControlARPipeline as TPipeline


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _pair(model_type, **over):
    kw = dict(model_type=model_type, dim=64, n_layer=6, n_head=4, vocab_size=96,
              num_classes=10, caption_dim=24, adapter_size="small",
              cls_token_num=1 if model_type == "c2i" else 6, block_size=16)
    kw.update(over)
    cfg = GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), cfg)
    # the t2i head is zero at init; give it weights so greedy tokens vary
    params["output"] = jax.random.normal(jax.random.PRNGKey(1), params["output"].shape)
    return cfg, params, TGPTConfig(**kw), convert.gpt_from_jax(_np_tree(params), TGPTConfig(**kw))


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


CASES = {
    "c2i_cfg_control": ("c2i", dict(cfg_scale=4.0)),
    "t2i_cfg_emb_masks": ("t2i", dict(cfg_scale=7.5)),
    "c2i_cfg_interval": ("c2i", dict(cfg_scale=4.0, cfg_interval=5)),
    "t2i_no_cfg": ("t2i", dict(cfg_scale=1.0)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_tokens_match_jax(case):
    model_type, opts = CASES[case]
    cfg, params, tcfg, model = _pair(model_type)
    cond = _conditioning(model_type, 3, cfg)
    want = jgen.generate(params, cfg, **{k: jnp.asarray(v) for k, v in cond.items()},
                         max_new_tokens=cfg.block_size, sample_logits=False, top_k=20,
                         control_strength=0.8, **opts)
    got = tgen.generate(model, tcfg, **{k: torch.from_numpy(v) for k, v in cond.items()},
                        max_new_tokens=tcfg.block_size, sample_logits=False, top_k=20,
                        control_strength=0.8, device="cpu", **opts)
    assert got.shape == (3, cfg.block_size)
    assert len(np.unique(np.asarray(want))) > 4  # a real token stream, not one id
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_greedy_tokens_through_the_flash_path():
    """use_flash=True on the CPU: the kernel's plain version, the 256-row
    cache and the additive column bias, against the JAX einsum path."""
    cfg, params, tcfg, model = _pair("t2i")
    cond = _conditioning("t2i", 3, cfg)
    want = jgen.generate(params, cfg, **{k: jnp.asarray(v) for k, v in cond.items()},
                         max_new_tokens=cfg.block_size, sample_logits=False, cfg_scale=4.0)
    got = tgen.generate(model, tcfg, **{k: torch.from_numpy(v) for k, v in cond.items()},
                        max_new_tokens=tcfg.block_size, sample_logits=False, cfg_scale=4.0,
                        use_flash=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_run_is_deterministic():
    _, _, tcfg, model = _pair("c2i")
    cond = {k: torch.from_numpy(v) for k, v in _conditioning("c2i", 3, tcfg).items()}
    runs = [tgen.generate(model, tcfg, **cond, max_new_tokens=tcfg.block_size, cfg_scale=4.0,
                          top_k=30, seed=s, device="cpu") for s in (5, 5, 6)]
    assert runs[0].shape == (3, tcfg.block_size)
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < tcfg.vocab_size
    np.testing.assert_array_equal(runs[0].numpy(), runs[1].numpy())
    assert not np.array_equal(runs[0].numpy(), runs[2].numpy())


def test_pipeline_matches_jax():
    """Canny -> adapter -> tokens -> VQ end to end. top_k=1 makes sampling
    deterministic in both packages; images agree within one uint8 step."""
    img = 64
    cfg, params, tcfg, model = _pair("c2i", block_size=(img // 16) ** 2)
    vq_kw = dict(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16)
    ad_cfg = jvit.ViTConfig(hidden_size=384, n_layer=2, n_head=2, patch_size=14, pos_grid=4,
                            layerscale=True)
    vq_params = jvq.init_vq_params(jax.random.PRNGKey(2), VQConfig(**vq_kw))
    ad_params = jvit.init_vit_params(jax.random.PRNGKey(3), ad_cfg)
    jpipe = JPipeline(gpt_cfg=cfg, gpt_params=params, vq_cfg=VQConfig(**vq_kw),
                      vq_params=vq_params, adapter_cfg=ad_cfg, adapter_params=ad_params)
    tad_cfg = tvit.ViTConfig(hidden_size=384, n_layer=2, n_head=2, patch_size=14, pos_grid=4,
                             layerscale=True)
    tpipe = TPipeline(gpt_cfg=tcfg, gpt=model, vq_cfg=TVQConfig(**vq_kw),
                      vq=convert.vq_from_jax(_np_tree(vq_params), TVQConfig(**vq_kw)),
                      adapter_cfg=tad_cfg,
                      adapter=convert.vit_from_jax(_np_tree(ad_params), tad_cfg),
                      device="cpu")
    images = np.random.default_rng(0).integers(0, 256, (2, img, img, 3)).astype(np.uint8)
    labels = np.array([3, 7])
    cond_j = jpipe.extract_condition(images)
    cond_t = tpipe.extract_condition(images)
    np.testing.assert_array_equal(cond_t.numpy(), np.asarray(cond_j))
    np.testing.assert_allclose(tpipe.control_features(cond_t).numpy(),
                               np.asarray(jpipe.control_features(cond_j)), atol=1e-4)
    want = jpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1)
    got = tpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1)
    assert got.shape == (2, img, img, 3) and got.dtype == np.uint8
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1


def test_pipeline_stage_clock_and_step_hook_leave_the_call_unchanged():
    """`timings` and `on_step` observe a generate call: the images are those
    of a plain call, every stage is timed and the hook sees each decode step."""
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vq as tvq

    img = 32
    tcfg = TGPTConfig(model_type="c2i", dim=64, n_layer=3, n_head=4, vocab_size=96,
                      num_classes=10, block_size=(img // 16) ** 2)
    vcfg = TVQConfig(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16)
    ad_cfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4)
    pipe = TPipeline(gpt_cfg=tcfg, gpt=tgpt.init_gpt(tcfg, seed=0, device="cpu"),
                     vq_cfg=vcfg, vq=tvq.init_vq(vcfg, seed=1, device="cpu"),
                     adapter_cfg=ad_cfg, adapter=tvit.init_vit(ad_cfg, seed=2, device="cpu"),
                     device="cpu")
    kw = dict(labels=np.array([3, 7]), cfg_scale=4.0, top_k=5, seed=3,
              condition_images=np.random.default_rng(0).integers(0, 256, (2, img, img, 3)
                                                                 ).astype(np.uint8))
    timings, steps = {}, []
    got = pipe.generate(**kw, timings=timings, on_step=steps.append)
    np.testing.assert_array_equal(got, pipe.generate(**kw))
    assert list(timings) == ["condition", "adapter", "tokens", "vq_decode"]
    assert all(t >= 0 for t in timings.values())
    assert steps == list(range(tcfg.block_size - 1))
