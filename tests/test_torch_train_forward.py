"""The port's training forward (`models/gpt.forward_train`) against the JAX
package's on the same weights and inputs: logits, loss and the parameter
gradients, c2i and t2i (left-padded captions), einsum and blockwise
attention, fp32; every remat policy gives the same gradients, and the flash
forward runs once per layer where its (out, lse) are saved, twice where the
layer is recomputed.

The JAX blockwise path is its Pallas training kernel (in interpret mode),
whose function the port's flash attention computes; JAX gradient trees are
compared through `convert.gpt_from_jax` applied to the gradient tree.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu_torch import convert
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.ops import flash_train as tft
from controlar_tpu_torch.remat import REMAT_POLICIES

B, BLOCK = 2, 16
_KW = dict(dim=64, n_layer=3, n_head=4, vocab_size=64, block_size=BLOCK, num_classes=10,
           caption_dim=32, token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0)
CASES = {"c2i": dict(model_type="c2i", cls_token_num=1),
         "t2i": dict(model_type="t2i", cls_token_num=8)}
# fp32 on both sides; the blockwise paths round q, k, v, p and ds to bf16 in
# the same places, and differ by the order of fp32 sums (which can flip one
# bf16 rounding of a p or ds, 2**-8 of that term)
TOL = {"einsum": (1e-5, 1e-4), "blockwise": (2e-4, 2e-3)}  # (rtol, atol relative to max)


def _setup(kind):
    kw = dict(_KW, **CASES[kind])
    jcfg, tcfg = JGPTConfig(**kw), GPTConfig(**kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    # the t2i head is zero at init, which would zero every other gradient
    params["output"] = jnp.asarray(rng.standard_normal(params["output"].shape) * 0.02,
                                   jnp.float32)
    cls = jcfg.cls_token_num
    t = cls + BLOCK - 1
    inputs = dict(
        prefix=rng.standard_normal((B, cls, 64)).astype(np.float32),
        idx=rng.integers(0, 64, (B, BLOCK - 1)).astype(np.int32),
        cond=(rng.standard_normal((B, BLOCK, 64)) * 0.5).astype(np.float32),
        targets=rng.integers(0, 64, (B, BLOCK)).astype(np.int32),
        valid=np.array([1.0, 1.0], np.float32),
        key_valid=None)
    if kind == "t2i":
        kv = np.ones((B, t), bool)
        kv[0, :3] = False  # left-padded captions
        kv[1, :6] = False
        inputs["key_valid"] = kv
    return jcfg, tcfg, params, inputs


def _jax_forward(jcfg, params, inputs, attn_impl):
    def loss_fn(p):
        logits, loss = jgpt.forward_train(
            p, jcfg, jnp.asarray(inputs["prefix"]), jnp.asarray(inputs["idx"]),
            cond_tokens=jnp.asarray(inputs["cond"]), targets=jnp.asarray(inputs["targets"]),
            valid=jnp.asarray(inputs["valid"]),
            key_valid=None if inputs["key_valid"] is None else jnp.asarray(inputs["key_valid"]),
            attn_impl=attn_impl)
        return loss, logits

    (loss, logits), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return np.asarray(logits), float(loss), grads


def _torch_forward(tcfg, model, inputs, attn_impl, remat="none", deterministic=True):
    for p in model.parameters():
        p.grad = None
    kv = inputs["key_valid"]
    logits, loss = tgpt.forward_train(
        model, tcfg, torch.from_numpy(inputs["prefix"]), torch.from_numpy(inputs["idx"]).long(),
        cond_tokens=torch.from_numpy(inputs["cond"]),
        targets=torch.from_numpy(inputs["targets"]).long(),
        valid=torch.from_numpy(inputs["valid"]),
        key_valid=None if kv is None else torch.from_numpy(kv), attn_impl=attn_impl,
        deterministic=deterministic, remat_policy=remat, rng=(0, 0))
    loss.backward()
    # parameters the forward does not read (the prefix embedders) have none
    return logits.detach(), loss.item(), {
        n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
        for n, p in model.named_parameters()}


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX blockwise path through its Pallas training kernel, run in
    interpret mode on the CPU."""
    monkeypatch.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
    monkeypatch.setattr(jftp, "flash_attention_train_pallas",
                        functools.partial(jftp.flash_attention_train_pallas, interpret=True))


def _close(got, want, attn_impl, what):
    rtol, atol = TOL[attn_impl]
    scale = float(np.abs(want).max()) or 1.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale, err_msg=what)


@pytest.mark.parametrize("attn_impl", ["einsum", "blockwise"])
@pytest.mark.parametrize("kind", ["c2i", "t2i"])
def test_forward_train_matches_jax(kind, attn_impl, pallas_interpret):
    jcfg, tcfg, params, inputs = _setup(kind)
    j_logits, j_loss, j_grads = _jax_forward(jcfg, params, inputs, attn_impl)
    model = convert.gpt_from_jax(params, tcfg).requires_grad_(True)
    t_logits, t_loss, t_grads = _torch_forward(tcfg, model, inputs, attn_impl)
    _close(t_logits.numpy(), j_logits, attn_impl, "logits")
    np.testing.assert_allclose(t_loss, j_loss, rtol=TOL[attn_impl][0] * 10)
    want = convert.gpt_from_jax(jax.tree.map(np.asarray, j_grads), tcfg).state_dict()
    assert set(want) == set(t_grads)
    for name, g in t_grads.items():
        _close(g.numpy(), want[name].numpy(), attn_impl, name)
    assert all(float(g.abs().max()) > 0 for n, g in t_grads.items() if n.startswith("layers."))


@pytest.mark.parametrize("kind", ["c2i", "t2i"])
def test_every_remat_policy_gives_the_same_gradients(kind, monkeypatch):
    _, tcfg, params, inputs = _setup(kind)
    model = convert.gpt_from_jax(params, tcfg).requires_grad_(True)
    calls = []
    plain = tft.flash_train_fwd_ref
    monkeypatch.setattr(tft, "flash_train_fwd_ref", lambda *a: (calls.append(1), plain(*a))[1])
    results = {}
    for remat in REMAT_POLICIES:
        calls.clear()
        results[remat] = _torch_forward(tcfg, model, inputs, "blockwise", remat=remat,
                                        deterministic=False)
        saved = remat in ("attn", "qkv_attn", "none")
        assert len(calls) == tcfg.n_layer * (1 if saved else 2), remat
    base = results["none"]
    for remat, (logits, loss, grads) in results.items():
        assert torch.equal(logits, base[0]) and loss == base[1], remat
        for name, g in grads.items():
            assert torch.equal(g, base[2][name]), (remat, name)
