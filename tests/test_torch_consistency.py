"""The port's condition extraction, generation under each control type, the
hed / lineart control train step, the controllability metrics and the
consistency evaluation against the JAX package's, on the CPU.

Small networks throughout (HED channels (4, 8, 8, 16, 16), lineart ngf 4,
a 3-layer MiDaS ViT of width 64, DPT of width 32), the same numpy weights
on both sides through `convert.*_from_jax`.

Tolerances: condition maps 5e-3 on 0..255 (fp32 networks, sums in another
order); greedy tokens exact (top_k=1 in both); images one uint8 step (the
VQ decoder in fp32); seg / unprocessed maps 1e-6 (a channel mean); the
train step's loss 2e-5 relative and gradients 1e-2 of each tensor's
largest, at least 1e-4 of the largest of all (as
`tests/test_torch_train_step.py` explains, both round the attention's p
and ds to bf16); F1, RMSE exact to fp64 rounding, MS-SSIM 1e-5; the consistency scores 1e-4 (the same tokens,
images within one step, re-extracted by the same detectors).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlar_tpu import generate as jgen
from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.config import VQConfig as JVQConfig
from controlar_tpu.convert.torch_dpt import convert_dpt_state_dict
from controlar_tpu.convert.torch_midas import convert_midas_state_dict
from controlar_tpu.convert.torch_control import (
    convert_hed_state_dict,
    convert_lineart_state_dict,
)
from controlar_tpu.eval import consistency as jcons
from controlar_tpu.eval import metrics as jmetrics
from controlar_tpu.models import dpt as jdpt
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import midas as jmidas
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu.pipeline import ControlARPipeline as JPipeline
from controlar_tpu.train.control_step import make_control_train_step as jmake_step
from controlar_tpu_torch import convert, convert_ref
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.eval import consistency as tcons
from controlar_tpu_torch.eval import metrics as tmetrics
from controlar_tpu_torch.models import dpt as tdpt
from controlar_tpu_torch.models import midas as tmidas
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq
from controlar_tpu_torch.pipeline import ControlARPipeline as TPipeline
from controlar_tpu_torch.train import control_step as tcs
from controlar_tpu_torch.train import optimizer as topt
from tests.test_torch_condition import hed_state_dict, lineart_state_dict

MAP_ATOL = 5e-3
LOSS_RTOL, GRAD_RTOL = 2e-5, 1e-2
SCORE_ATOL = 1e-4

_HED_CH = (4, 8, 8, 16, 16)
_DPT = dict(hidden_size=32, n_layer=4, n_head=2, mlp_dim=64, patch_size=16, pos_grid=4,
            out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 24, 32, 32),
            reassemble_factors=(4, 2, 1, 0.5), fusion_hidden_size=24)
_MIDAS = dict(stem_width=32, layers=(1, 1, 1), hidden_size=64, n_layer=3, n_head=2,
              mlp_dim=128, pos_grid=4, vit_hooks=(1, 2), features=32,
              layer_channels=(256, 512, 64, 64))
_ADAPTER = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4,
                layerscale=True)
_VQ = dict(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16, num_res_blocks=1)


@functools.lru_cache(maxsize=None)
def _jit_init(fn):
    """A JAX init (key, config) compiled once, rather than op by op."""
    return jax.jit(fn, static_argnums=1)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
        np.shape(a)).astype(np.float32)), tree)


@functools.lru_cache(maxsize=None)
def _nets():
    """One set of small condition networks: JAX trees and the port's modules."""
    hed = jax.tree.map(jnp.asarray, convert_hed_state_dict(hed_state_dict(0, _HED_CH)))
    lineart = jax.tree.map(jnp.asarray, convert_lineart_state_dict(lineart_state_dict(0, 4)))
    mcfg = jmidas.MidasHybridConfig(**_MIDAS)
    midas = _noisy(convert_midas_state_dict(_ref_sd(tmidas.init_midas(
        tmidas.MidasHybridConfig(**_MIDAS), seed=1, device="cpu"), convert_ref._MIDAS_RULES),
        mcfg), 1)
    dcfg = jdpt.DPTConfig(**_DPT)
    dpt = _noisy(_dpt_tree(dcfg), 2)
    jax_nets = dict(hed_params=hed, lineart_params=lineart, midas_params=midas, midas_cfg=mcfg,
                    dpt_params=dpt, dpt_cfg=dcfg)
    tmcfg, tdcfg = tmidas.MidasHybridConfig(**_MIDAS), tdpt.DPTConfig(**_DPT)
    torch_nets = dict(hed=convert.hed_from_jax(_np_tree(hed)),
                      lineart=convert.lineart_from_jax(_np_tree(lineart)),
                      midas=convert.midas_from_jax(_np_tree(midas), tmcfg), midas_cfg=tmcfg,
                      dpt=convert.dpt_from_jax(_np_tree(dpt), tdcfg), dpt_cfg=tdcfg)
    return jax_nets, torch_nets


def _ref_sd(model, rules):
    """A port module's state dict in a checkpoint's key layout (the names
    `convert_ref` reads), as numpy."""
    out = {}
    for name, t in model.state_dict().items():
        for pattern, repl in rules:
            name = re.sub(pattern, repl, name)
        out[name] = t.numpy()
    return out


@functools.lru_cache(maxsize=None)
def _vq_pair():
    """(JAX decoder tree, port VQ): the port's random decoder carried into
    the JAX package's layout (the structure from its init, traced only)."""
    tvq_model = tvq.init_vq(VQConfig(**_VQ), seed=2)
    sd = {k: v.numpy() for k, v in tvq_model.state_dict().items()}
    shapes = jax.eval_shape(lambda k: jvq.init_vq_params(k, JVQConfig(**_VQ)),
                            jax.random.PRNGKey(0))

    def fill(path, _):
        names = [str(getattr(p, "key", getattr(p, "idx", None))) for p in path]
        stem, leaf = ".".join(names[:-1]), names[-1]
        if leaf == "w":
            return np.transpose(sd[f"{stem}.weight"], (2, 3, 1, 0))
        return sd[f"{stem}.bias"] if leaf == "b" else sd[".".join(names)]

    tree = {k: shapes[k] for k in ("post_quant_conv", "codebook", "decoder")}
    return jax.tree_util.tree_map_with_path(fill, tree), tvq_model


def _dpt_tree(cfg):
    """A random JAX DPT tree: the port's random module in HF's key layout,
    through the JAX package's converter."""
    m = tdpt.init_dpt(tdpt.DPTConfig(**_DPT), seed=3, device="cpu")
    return convert_dpt_state_dict(_ref_sd(m, convert_ref._DPT_RULES), cfg)


def _depth_fn(images_u8):
    """A stand-in detector: the mean of the channels, as a 0..255 map."""
    return np.asarray(images_u8, np.float32).mean(-1)


@functools.lru_cache(maxsize=None)
def _pipelines(ct, img, depth="midas"):
    """(JAX pipeline, port pipeline on the CPU) of a tiny c2i model with the
    condition type `ct`, the same weights on both sides. depth picks the
    depth route: "midas", "dpt" or "fn" (depth_fn). The JAX pipeline's
    extract_condition is jitted (but for depth_fn, a host function)."""
    jax_nets, torch_nets = _nets()
    kw = dict(model_type="c2i", dim=64, n_layer=3, n_head=4, vocab_size=96,
              num_classes=10, cls_token_num=1, block_size=(img // 16) ** 2)
    cfg = JGPTConfig(**kw)
    params = _jit_init(jgpt.init_gpt_params)(jax.random.PRNGKey(0), cfg)
    ad_cfg = jvit.ViTConfig(**_ADAPTER)
    ad = _jit_init(jvit.init_vit_params)(jax.random.PRNGKey(3), ad_cfg)
    vq, port_vq = _vq_pair()
    nets_j, nets_t = dict(jax_nets), dict(torch_nets)
    if ct == "depth":
        drop = {"midas": ("dpt",), "dpt": ("midas",), "fn": ("midas", "dpt")}[depth]
        for name in drop:
            nets_j.pop(f"{name}_params"), nets_j.pop(f"{name}_cfg")
            nets_t.pop(name), nets_t.pop(f"{name}_cfg")
        if depth == "fn":
            nets_j["depth_fn"] = nets_t["depth_fn"] = _depth_fn
    jpipe = JPipeline(gpt_cfg=cfg, gpt_params=params, vq_cfg=JVQConfig(**_VQ), vq_params=vq,
                      adapter_cfg=ad_cfg, adapter_params=ad, condition_type=ct, **nets_j)
    tpipe = TPipeline(gpt_cfg=GPTConfig(**kw), gpt=convert.gpt_from_jax(_np_tree(params),
                                                                        GPTConfig(**kw)),
                      vq_cfg=VQConfig(**_VQ), vq=port_vq,
                      adapter_cfg=tvit.ViTConfig(**_ADAPTER),
                      adapter=convert.vit_from_jax(_np_tree(ad), tvit.ViTConfig(**_ADAPTER)),
                      condition_type=ct, device="cpu", **nets_t)
    if depth != "fn":
        jpipe.extract_condition = jax.jit(jpipe.extract_condition,
                                          static_argnames=("canny_low", "canny_high",
                                                           "preprocess"))
    return jpipe, tpipe


def _images(b, h, w, seed=0):
    """Blocky RGB images with edges, uint8."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (b, h // 8, w // 8, 3)).astype(np.uint8)
    img = low.repeat(8, axis=1).repeat(8, axis=2).astype(np.int32)
    return np.clip(img + rng.integers(-6, 7, img.shape), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# extract_condition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ct,depth,hw", [
    ("hed", None, (64, 64)), ("hed", None, (64, 96)),
    ("lineart", None, (64, 64)), ("lineart", None, (32, 48)),
    ("depth", "midas", (64, 64)), ("depth", "midas", (64, 96)),
    ("depth", "dpt", (64, 64)), ("depth", "dpt", (96, 64)),
    ("depth", "fn", (64, 64)),
])
def test_extract_condition_matches_jax(ct, depth, hw):
    jpipe, tpipe = _pipelines(ct, 64, depth=depth)
    images = _images(2, *hw)
    want = np.asarray(jpipe.extract_condition(images))
    got = tpipe.extract_condition(images).numpy()
    assert got.shape == want.shape
    assert want.std() > 1e-3 and -1 <= want.min() and want.max() <= 1 + 1e-6
    np.testing.assert_allclose(got, want, atol=2 * MAP_ATOL / 255)


@pytest.mark.parametrize("ct", ["seg", "hed"])
def test_rendered_maps_pass_through(ct):
    """'seg' and preprocess=False read the input as a rendered map, as before."""
    jpipe, tpipe = _pipelines(ct, 64)
    images = _images(2, 64, 64, seed=1)
    np.testing.assert_allclose(
        tpipe.extract_condition(images, preprocess=ct == "seg").numpy(),
        np.asarray(JPipeline.extract_condition(jpipe, images, preprocess=ct == "seg")),
        atol=1e-6)


def test_missing_network_raises():
    tpipe = dataclasses.replace(_pipelines("lineart", 64)[1], lineart=None)
    with pytest.raises(ValueError, match="lineart"):
        tpipe.extract_condition(_images(1, 64, 64))


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ct,depth", [("hed", None), ("lineart", None), ("depth", "midas"),
                                      ("depth", "dpt")])
def test_greedy_generate_matches_jax(ct, depth):
    """The pipelines' condition and adapter, then generate with top_k=1:
    the same tokens; the pipelines' images within one uint8 step."""
    img = 64
    jpipe, tpipe = _pipelines(ct, img, depth=depth)
    images, labels = _images(2, img, img, seed=2), np.array([3, 7])
    feats_j = jpipe.control_features(jpipe.extract_condition(images))
    feats_t = tpipe.control_features(tpipe.extract_condition(images))
    want = jgen.generate(jpipe.gpt_params, jpipe.gpt_cfg, labels=jnp.asarray(labels),
                         adapter_features=feats_j, max_new_tokens=jpipe.gpt_cfg.block_size,
                         cfg_scale=4.0, top_k=1, rng=jax.random.PRNGKey(0))
    got = tgen.generate(tpipe.gpt, tpipe.gpt_cfg, labels=torch.from_numpy(labels),
                        adapter_features=feats_t, max_new_tokens=tpipe.gpt_cfg.block_size,
                        cfg_scale=4.0, top_k=1, seed=0, device="cpu")
    assert len(np.unique(np.asarray(want))) > 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    out_j = jpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1)
    out_t = tpipe.generate(labels=labels, condition_images=images, cfg_scale=4.0, top_k=1)
    assert out_t.shape == (2, img, img, 3) and out_t.dtype == np.uint8
    assert np.abs(out_t.astype(np.int16) - out_j.astype(np.int16)).max() <= 1


# ---------------------------------------------------------------------------
# the control train step
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
    monkeypatch.setattr(jftp, "flash_attention_train_pallas",
                        functools.partial(jftp.flash_attention_train_pallas, interpret=True))


@pytest.mark.parametrize("ct,kind", [("hed", "t2i"), ("lineart", "c2i")])
def test_control_step_loss_and_grads_match_jax(ct, kind, pallas_interpret):
    """One fp32 step with the frozen network: the JAX step with an optimizer
    that keeps the gradients as its state; the port's loss_fn and autograd."""
    img, b = 64, 2
    kw = dict(model_type=kind, dim=64, n_layer=3, n_head=4, block_size=16, vocab_size=64,
              num_classes=10, cls_token_num=8 if kind == "t2i" else 1, caption_dim=32,
              token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
              class_dropout_prob=0.0)
    jcfg, tcfg = JGPTConfig(**kw), GPTConfig(**kw)
    jad, tad = jvit.ViTConfig(**_ADAPTER), tvit.ViTConfig(**_ADAPTER)
    params = {"gpt": _jit_init(jgpt.init_gpt_params)(jax.random.PRNGKey(0), jcfg),
              "adapter": _jit_init(jvit.init_vit_params)(jax.random.PRNGKey(1), jad)}
    rng = np.random.default_rng(1)  # the t2i head is zero at init
    params["gpt"]["output"] = jnp.asarray(
        rng.standard_normal(params["gpt"]["output"].shape) * 0.02, jnp.float32)
    batch = {"tokens": rng.integers(0, 64, (b, 16)).astype(np.int32),
             "control_image": _images(b, img, img, seed=3), "valid": np.ones((b,), np.float32)}
    if kind == "t2i":
        batch["caption_emb"] = rng.standard_normal((b, 8, 32)).astype(np.float32)
        batch["emb_mask"] = (np.arange(8)[None, :] >= np.array([3, 0])[:, None]).astype(np.int32)
    else:
        batch["labels"] = np.array([3, 7], np.int32)
    jax_nets, torch_nets = _nets()
    jfrozen = {ct: jax_nets[f"{ct}_params"]}
    from controlar_tpu.train.step import TrainState

    zeros = functools.partial(jax.tree.map, jnp.zeros_like)
    tx = optax.GradientTransformation(zeros, lambda g, s, p=None: (zeros(g), g))
    jstep = jax.jit(jmake_step(jcfg, jad, tx, ct, frozen=jfrozen, compute_dtype=jnp.float32))
    state = TrainState(step=jnp.asarray(0), params=params, opt_state=tx.init(params),
                       ema_params=None)
    new, metrics = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()},
                         jax.random.PRNGKey(0))
    jgrads = _np_tree(new.opt_state)

    model = tcs.ControlModel(convert.gpt_from_jax(_np_tree(params["gpt"]), tcfg),
                             convert.vit_from_jax(_np_tree(params["adapter"]), tad))
    frozen = topt.frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen[n])
    fn = tcs.make_control_train_step(tcfg, tad, topt.make_optimizer(lr=1e-3), ct,
                                     frozen={ct: torch_nets[ct]}, compute_dtype=torch.float32)
    loss = fn.loss_fn(model, {k: torch.from_numpy(v) for k, v in batch.items()}, (0, 0))
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [dict(model.named_parameters())[n] for n in names])
    assert loss.item() == pytest.approx(float(metrics["loss"]), rel=LOSS_RTOL)
    want = tcs.ControlModel(convert.gpt_from_jax(_np_tree(jgrads["gpt"]), tcfg),
                            convert.vit_from_jax(_np_tree(jgrads["adapter"]), tad)).state_dict()
    assert not any(p.requires_grad for p in torch_nets[ct].parameters())
    # a tensor whose gradient is zero in exact arithmetic (a key bias) is held
    # to 1e-4 of the largest gradient instead of its own rounding noise
    floor = 1e-4 * max(want[n].abs().max().item() for n in names)
    for n, g in zip(names, grads):
        scale = max(want[n].abs().max().item(), floor)
        assert (g - want[n]).abs().max().item() <= GRAD_RTOL * scale, n


# ---------------------------------------------------------------------------
# metrics and the consistency evaluation
# ---------------------------------------------------------------------------

def test_f1_and_rmse_match_jax():
    rng = np.random.default_rng(4)
    pairs = [(rng.integers(0, 256, (32, 40)), rng.integers(0, 256, (32, 40))) for _ in range(3)]
    pairs.append((np.zeros((8, 8)), np.zeros((8, 8))))  # no positives: F1 0
    for cls in ("F1score", "RMSE"):
        j, t = getattr(jmetrics, cls)(), getattr(tmetrics, cls)()
        for a, b in pairs:
            j.update(a, b)
            t.update(a, b)
        assert t.calculate() == pytest.approx(j.calculate(), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("shape", [(192, 200), (180, 176, 3)])
def test_ssim_matches_jax(shape):
    rng = np.random.default_rng(5)
    a = rng.integers(0, 256, shape).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-40, 41, shape), 0, 255).astype(np.uint8)
    j, t = jmetrics.SSIM(), tmetrics.SSIM(device="cpu")
    for x, y in ((a, b), (a, a)):
        j.update(x, y)
        t.update(x, y)
    assert t.calculate() == pytest.approx(j.calculate(), abs=1e-5)
    assert 0.3 < j.calculate() < 1.0


@pytest.mark.parametrize("ct,img", [("canny", 64), ("hed", 192)])
def test_consistency_eval_matches_jax(ct, img):
    """Generate with top_k=1, re-extract, score: the same number as the JAX
    package's evaluation (MS-SSIM needs 176 px or more)."""
    jpipe, tpipe = _pipelines(ct, img)
    batches = [{"condition_images": _images(2, img, img, seed=6 + i),
                "labels": np.array([1 + i, 5])} for i in range(2 if ct == "canny" else 1)]
    kw_j = {"hed_params": jpipe.hed_params} if ct == "hed" else {}
    kw_t = {"hed": tpipe.hed} if ct == "hed" else {}
    want = jcons.consistency_eval(jpipe, batches, ct, cfg_scale=4.0, top_k=1, **kw_j)
    got = tcons.consistency_eval(tpipe, batches, ct, cfg_scale=4.0, top_k=1, device="cpu",
                                 **kw_t)
    assert 0.0 < want < 1.0
    assert got == pytest.approx(want, abs=SCORE_ATOL)
