"""The port's Adafactor against optax's chain(clip_by_global_norm(1.0),
adafactor(learning_rate)) at optax's defaults, the JAX package's toy
training optimizer (`scripts/toy_train_quant.py`), on the CPU.

The parameters are a tiny t2i GPT's, from the JAX package's stacked tree
(two layers; the token table, the output head, wqkv, w1 / w3 / w2 and the
three condition MLPs have two dimensions of at least 128, so they are
factored; the zero output head takes the minimum parameter scale), carried
into the port's per-layer tensors. Five steps of the same seeded gradients,
global norms below and above the clip, the frozen caption embedding zero.

Tolerance: parameters 1e-6 relative (1e-10 absolute near zero): the factored
statistics, both RMS values over the stacked leaves and the updates are fp32
sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.train import optimizer as jopt
from controlar_tpu_torch import convert, toy_train
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.train import optimizer as topt

RTOL, ATOL = 1e-6, 1e-10
LR = 3e-4
GPT_KW = dict(model_type="t2i", dim=128, n_layer=2, n_head=2, block_size=16, vocab_size=256,
              cls_token_num=8, caption_dim=32)


def _to_torch(tree):
    return {n: t.clone() for n, t in convert.gpt_from_jax(
        jax.tree.map(np.asarray, tree), GPTConfig(**GPT_KW)).state_dict().items()}


def test_jax_leaf():
    assert topt.jax_leaf("layers.3.wqkv.weight") == "layers.*.wqkv.weight"
    assert topt.jax_leaf("gpt.layers.10.attention_norm") == "gpt.layers.*.attention_norm"
    assert topt.jax_leaf("adapter.layers.0.q.weight") == "adapter.layers.*.q.weight"
    assert topt.jax_leaf("condition_layers.2.fc1.weight") == "condition_layers.*.fc1.weight"
    assert topt.jax_leaf("tok_embeddings.weight") == "tok_embeddings.weight"
    assert topt.jax_leaf("encoder.levels.0.res.1.conv1.weight") == \
        "encoder.levels.0.res.1.conv1.weight"


@pytest.mark.parametrize("scales", [(1e-3, 1e-3, 1e-3, 1e-3, 1e-3), (1e-3, 3.0, 1e-2, 5.0, 1e-3)])
def test_adafactor_matches_optax(scales):
    """Five steps; `scales` sets each step's gradient size (a global norm
    of ~5 at 1e-3, so the large ones clip)."""
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), JGPTConfig(**GPT_KW))
    rng = np.random.default_rng(1)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * s, jnp.float32),
                          params) for s in scales]
    jtx = optax.chain(optax.clip_by_global_norm(1.0), optax.adafactor(learning_rate=LR))
    jparams, jst = params, jtx.init(params)
    jupdate = jax.jit(jtx.update)
    tparams = _to_torch(params)
    ttx = topt.Adafactor(lr=LR)
    tst = ttx.init(tparams)
    factored = set(tst.v_row)
    assert {"tok_embeddings.weight", "output.weight", "layers.0.wqkv.weight",
            "layers.1.w2.weight", "condition_layers.2.fc1.weight"} <= factored
    assert "layers.0.attention_norm" in tst.v and "norm" in tst.v
    for g in grads:
        g = jopt.zero_frozen_grads(g)
        upd, jst = jupdate(g, jst, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tst, norm = ttx.step(tparams, topt.zero_frozen_grads(_to_torch(g), tparams), tst)
        np.testing.assert_allclose(norm.item(), float(optax.global_norm(g)), rtol=1e-6)
    assert tst.count == len(scales)
    want = _to_torch(jparams)
    for n, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=RTOL, atol=ATOL, err_msg=n)
    assert float(tparams["output.weight"].abs().max()) > 0  # moved at the minimum scale
    assert torch.equal(tparams["cls_embedding.uncond_embedding"],
                       _to_torch(params)["cls_embedding.uncond_embedding"])


def test_block_rms_spans_the_stacked_layers():
    """The parameter scale is the RMS of the whole stacked leaf: the other
    layer's parameters set this layer's step, which they do not for two
    leaves that are not stacked."""
    tx = topt.Adafactor(lr=1.0)
    params = {"layers.0.w": torch.ones(4), "layers.1.w": torch.full((4,), 3.0)}
    g0 = {"layers.0.w": torch.tensor([1.0, -1, 1, -1]), "layers.1.w": torch.tensor([1.0, 1, 1, 1])}
    p = {n: t.clone() for n, t in params.items()}
    tx.step(p, g0, tx.init(p))
    # u = sign(g) everywhere (rms 1, no clip); p_rms over both layers = sqrt(5)
    np.testing.assert_allclose(p["layers.0.w"].numpy(), 1 - np.sqrt(5.0) * np.sign(
        g0["layers.0.w"].numpy()), rtol=1e-6)
    per_layer = {"a.w": torch.ones(4), "b.w": torch.full((4,), 3.0)}
    tx.step(per_layer, {"a.w": g0["layers.0.w"], "b.w": g0["layers.1.w"]}, tx.init(per_layer))
    np.testing.assert_allclose(per_layer["a.w"].numpy(), 1 - np.sign(g0["layers.0.w"].numpy()),
                               rtol=1e-6, atol=1e-6)


def test_layer_axis_that_optax_would_factor_is_refused():
    params = {f"layers.{i}.norm": torch.ones(256) for i in range(128)}
    with pytest.raises(NotImplementedError, match="layer axis"):
        topt.Adafactor().init(params)


def test_toy_train_with_adafactor_lowers_the_loss():
    cfg = toy_train.toy_config("GPT-B", 16, dim=64, n_layer=2, n_head=2)
    res = toy_train.train(cfg, steps=8, batch=4, lr=1e-2, num_classes_used=4,
                          optimizer="adafactor", device="cpu", log=lambda m: None)
    losses = res["step_losses"]
    assert isinstance(res["state"].opt_state, topt.AdafactorState)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match="optimizer"):
        toy_train.train(cfg, steps=1, optimizer="sgd", device="cpu", log=lambda m: None)
