"""Arbitrary-resolution control training in the port against the JAX
package, fp32 on the CPU: `GPTConfig.with_resolution` and the rectangular
RoPE table, the bucket set and its sampling, the multiscale step's loss and
gradients at two buckets (the shapes of the JAX package's
`tests/test_multiscale_train.py`) with HED through the frozen networks, and
the condition map that ignores the other frozen entries.

Weights: one JAX tree (its GPT and ViT inits, a numpy-filled VQ, a HED
state dict in the annotator's layout) carried into the port. The JAX step's
blockwise attention runs its Pallas training kernel in interpret mode, whose
function the port's flash attention computes; the step's gradients are read
from an optax transformation that stores them as its state. Dropout and
class dropout 0, so both steps are deterministic.

Tolerances: the loss 1e-5 relative; each gradient 1e-3 of its largest
magnitude, floored at 1e-2 of the model's largest (fp32, through a VQ
encode, HED, a bicubic resize, the adapter and six layers summed in another
order); RoPE tables exact; buckets identical.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.config import VQConfig as JVQConfig
from controlar_tpu.convert.torch_control import convert_hed_state_dict
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.models import vq as jvq
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu.ops import rope as jrope
from controlar_tpu.train import multiscale as jms
from controlar_tpu.train.step import init_train_state as jinit_state
from controlar_tpu_torch import convert, convert_ref
from controlar_tpu_torch.config import GPTConfig, VQConfig
from controlar_tpu_torch.models import control_nets as tcn
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.ops import rope as trope
from controlar_tpu_torch.train import control_step as tcs
from controlar_tpu_torch.train import multiscale as tms
from controlar_tpu_torch.train import optimizer as topt
from controlar_tpu_torch.train import step as tstep
from tests.port_data_helpers import random_vq_params

LOSS_RTOL = 1e-5
GRAD_TOL, GRAD_FLOOR = 1e-3, 1e-2

GPT_KW = dict(model_type="t2i", dim=64, n_layer=6, n_head=2, block_size=16, vocab_size=64,
              cls_token_num=120, caption_dim=48, token_dropout_p=0.0, resid_dropout_p=0.0,
              ffn_dropout_p=0.0, class_dropout_prob=0.0)
ADAPTER_KW = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4,
                  layerscale=True)
VQ_KW = dict(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16)
HED_WIDTHS = (4, 8, 8, 16, 16)
BUCKETS = ((64, 64), (64, 96))


# ---------------------------------------------------------------------------
# configuration, RoPE, buckets
# ---------------------------------------------------------------------------

def test_with_resolution_and_grid_size():
    base_kw = dict(model_type="c2i", dim=64, n_layer=4, n_head=2, cls_token_num=1,
                   block_size=64, vocab_size=128, num_classes=10)
    got, want = GPTConfig(**base_kw).with_resolution(4, 10), \
        JGPTConfig(**base_kw).with_resolution(4, 10)
    assert (got.block_size, got.grid_hw, got.grid) == (want.block_size, want.grid_hw,
                                                       want.grid) == (40, (4, 10), (4, 10))
    assert GPTConfig(**base_kw).grid_size == JGPTConfig(**base_kw).grid_size == 8
    with pytest.raises(AssertionError):
        got.grid_size  # noqa: B018  (40 tokens: not a square)
    np.testing.assert_array_equal(
        trope.precompute_rope_2d_rect(4, 10, 32, 10000.0, 1),
        np.asarray(jgpt.make_rope_table(want)))


def test_rect_rope_equals_square_prefix_rows():
    """A rectangular table whose width is the square grid's equals the
    square table's leading rows."""
    sq = trope.precompute_rope_2d(8, 64, 10000.0, 120)
    rect = trope.precompute_rope_2d_rect(3, 8, 64, 10000.0, 120)
    np.testing.assert_array_equal(rect, sq[: 120 + 24])
    np.testing.assert_array_equal(rect, jrope.precompute_rope_2d_rect(3, 8, 64, 10000.0, 120))


def test_rect_rope_differs_from_naive_slice_when_w_differs():
    sq = trope.precompute_rope_2d(8, 64, 10000.0, 0)
    rect = trope.precompute_rope_2d_rect(4, 6, 64, 10000.0, 0)
    assert not np.allclose(rect, sq[:24])
    np.testing.assert_array_equal(rect, jrope.precompute_rope_2d_rect(4, 6, 64, 10000.0, 0))


@pytest.mark.parametrize("args", [(384, 1024, 64, 2304, 16), (384, 1024, 16, 2304, 16),
                                  (256, 512, 32, 1024, 8), (64, 96, 32, 24, 16)])
def test_resolution_buckets_match_jax(args):
    got = tms.resolution_buckets(*args)
    assert got == jms.resolution_buckets(*args)
    assert all((h // args[4]) * (w // args[4]) <= args[3] for h, w in got)
    r1, r2 = np.random.default_rng(0), np.random.default_rng(0)
    assert [tms.sample_bucket(r1, got) for _ in range(20)] == \
        [jms.sample_bucket(r2, got) for _ in range(20)]


def test_budget_bucket():
    buckets = tms.resolution_buckets(384, 1024, 64, 2304, 16)
    assert {(512, 512), (384, 768), (1024, 576)} <= set(buckets)
    assert (1024, 1024) not in buckets


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------

@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
    monkeypatch.setattr(jftp, "flash_attention_train_pallas",
                        functools.partial(jftp.flash_attention_train_pallas, interpret=True))


def _hed_sd(seed=0):
    """A small HED in the annotator's key layout (norm (1, 3, 1, 1))."""
    hed = tcn.init_hed(seed=seed, device="cpu", channels=HED_WIDTHS)
    sd = {k: v.numpy() for k, v in convert_ref.reference_state_dict(
        hed, [(r"^blocks\.(\d)\.", lambda m: f"block{int(m[1]) + 1}.")]).items()}
    sd["norm"] = sd["norm"].reshape(1, 3, 1, 1)
    return sd


@functools.lru_cache(maxsize=None)
def _setup():
    jcfg = JGPTConfig(**GPT_KW)
    jad = jvit.ViTConfig(**ADAPTER_KW)
    params = {"gpt": jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg),
              "adapter": jvit.init_vit_params(jax.random.PRNGKey(1), jad)}
    # the t2i head is zero at init, which would zero every other gradient
    params["gpt"]["output"] = jnp.asarray(np.random.default_rng(2).standard_normal(
        params["gpt"]["output"].shape) * 0.02, jnp.float32)
    vq_tree = random_vq_params(JVQConfig(**VQ_KW), seed=3)
    hed_sd = _hed_sd()
    return jcfg, jad, params, vq_tree, hed_sd


def _batch(hw, seed):
    rng = np.random.default_rng(seed)
    em = np.ones((2, 120), bool)
    em[0, :40] = False  # a left-padded caption
    return {"images": rng.uniform(-1, 1, (2, *hw, 3)).astype(np.float32),
            "caption_emb": rng.standard_normal((2, 120, 48)).astype(np.float32),
            "emb_mask": em, "valid": np.ones((2,), np.float32)}


def _grad_store():
    """An optax transformation whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _port_model(params):
    tree = jax.tree.map(np.asarray, params)
    return tcs.ControlModel(convert.gpt_from_jax(tree["gpt"], GPTConfig(**GPT_KW)),
                            convert.vit_from_jax(tree["adapter"], tvit.ViTConfig(**ADAPTER_KW)))


def test_multiscale_step_matches_jax_at_two_buckets(pallas_interpret):
    """The loss and every gradient at 64 x 64 (16 tokens) and 64 x 96 (24,
    a rectangular grid), HED condition, `frozen` holding the tokenizer and
    HED; one JAX step (and one port step) per bucket, the state's step
    advancing."""
    jcfg, jad, params, vq_tree, hed_sd = _setup()
    frozen = {"vq": vq_tree, "hed": jax.tree.map(jnp.asarray, convert_hed_state_dict(hed_sd))}
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, _grad_store(), params=params)
    jstep = jax.jit(jms.make_multiscale_train_step(jcfg, jad, JVQConfig(**VQ_KW), _grad_store(),
                                                   "hed", frozen=frozen,
                                                   compute_dtype=jnp.float32))
    model = _port_model(params)
    tfrozen = {"vq": convert.vq_from_jax(vq_tree, VQConfig(**VQ_KW)),
               "hed": convert_ref.hed_from_state_dict(hed_sd, device="cpu")}
    fn = tms.make_multiscale_train_step(GPTConfig(**GPT_KW), tvit.ViTConfig(**ADAPTER_KW),
                                        VQConfig(**VQ_KW), topt.make_optimizer(lr=0.0), "hed",
                                        frozen=tfrozen, compute_dtype=torch.float32,
                                        device="cpu")
    frozen_names = topt.frozen_mask(dict(model.named_parameters()))
    params_t = {n: p.requires_grad_(not frozen_names[n]) for n, p in model.named_parameters()}
    for i, hw in enumerate(BUCKETS):
        batch = _batch(hw, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(7))
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        loss = fn.loss_fn(model, tb, (7, i))
        trainable = {n: p for n, p in params_t.items() if p.requires_grad}
        grads = dict(zip(trainable, torch.autograd.grad(loss, list(trainable.values()))))
        np.testing.assert_allclose(loss.item(), float(jm["loss"]), rtol=LOSS_RTOL,
                                   err_msg=f"loss at {hw}")
        want = {n: t for n, t in _port_model(jstate.opt_state).state_dict().items()}
        floor = GRAD_FLOOR * max(float(w.abs().max()) for w in want.values())
        for n, g in grads.items():
            err = float((g - want[n]).abs().max()) / max(float(want[n].abs().max()), floor)
            assert err <= GRAD_TOL, f"{n} at {hw}: {err}"
    assert int(jstate.step) == 2


def test_multiscale_step_trains_and_encodes(pallas_interpret):
    """Two AdamW steps of the port's step: finite losses, the state's step
    and the codes the step encodes equal a direct encode."""
    jcfg, jad, params, vq_tree, hed_sd = _setup()
    model = _port_model(params)
    frozen = {"vq": convert.vq_from_jax(vq_tree, VQConfig(**VQ_KW)),
              "hed": convert_ref.hed_from_state_dict(hed_sd, device="cpu")}
    frozen_names = topt.frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen_names[n])
    tx = topt.make_optimizer(lr=1e-3)
    state = tstep.init_train_state(model, tx)
    fn = tms.make_multiscale_train_step(GPTConfig(**GPT_KW), tvit.ViTConfig(**ADAPTER_KW),
                                        VQConfig(**VQ_KW), tx, "hed", frozen=frozen,
                                        compute_dtype=torch.float32, device="cpu")
    for i, hw in enumerate(BUCKETS):
        tb = {k: torch.from_numpy(v) for k, v in _batch(hw, seed=20 + i).items()}
        state, m = fn(model, state, tb, 0)
        assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
        codes = tms.encode_codes(frozen["vq"], VQConfig(**VQ_KW), tb["images"])
        _, direct = jvq.encode(vq_tree, JVQConfig(**VQ_KW), jnp.asarray(tb["images"].numpy()))
        assert codes.shape == (2, (hw[0] // 16) * (hw[1] // 16))
        assert np.array_equal(codes.numpy(), np.asarray(direct).reshape(2, -1))
    assert state.step == 2


def test_condition_ignores_other_frozen_entries():
    """`frozen` may hold the tokenizer beside the condition's network: the
    map is the same as with the network alone (it used to be passed on as a
    keyword, which condition_map refuses)."""
    hed = convert_ref.hed_from_state_dict(_hed_sd(), device="cpu")
    vq = convert.vq_from_jax(random_vq_params(JVQConfig(**VQ_KW), seed=3), VQConfig(**VQ_KW))
    img = np.random.default_rng(4).integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    batch = {"control_image": torch.from_numpy(img)}
    want = tcs.extract_condition_on_device(batch, "hed", {"hed": hed})
    got = tcs.extract_condition_on_device(batch, "hed", {"vq": vq, "hed": hed})
    assert torch.equal(got, want)
    canny = tcs.extract_condition_on_device(batch, "canny", {"vq": vq, "hed": hed})
    assert torch.equal(canny, tcs.extract_condition_on_device(batch, "canny", None))
