"""The port's training step, optimizer, trainer and checkpoints against the
JAX package on the same numpy inputs.

- three steps of `make_control_train_step` (Canny -> trained DINOv2 adapter
  -> control fusion -> CE loss -> AdamW, EMA) against the JAX step with
  optax: c2i and t2i, fp32 and bf16 compute (bf16 with bf16 Adam moments),
  class dropout 0 and 1 (both deterministic), other dropout 0;
- AdamW against optax's chain(clip_by_global_norm, adamw(mask=decay_mask))
  on the same gradients, fp32 and bf16 moments, with and without clipping;
- the decay-mask rule against the JAX package's on the same trees; the
  frozen `uncond_embedding`;
- `Trainer.fit` through `ShardedLoader` on a tiny in-memory dataset;
  checkpoint and resume continue the uninterrupted run exactly;
- dropout statistics: kept share and scale.

The JAX step's blockwise attention runs its Pallas training kernel in
interpret mode, whose function the port's flash attention computes.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu.train import optimizer as jopt
from controlar_tpu.train.control_step import make_control_train_step as jmake_step
from controlar_tpu.train.step import init_train_state as jinit_state
from controlar_tpu_torch import convert
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.data.loader import ShardedLoader
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.train import control_step as tcs
from controlar_tpu_torch.train import optimizer as topt
from controlar_tpu_torch.train import step as tstep
from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG, B, LR = 64, 2, 1e-3
_ADAPTER = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4,
                layerscale=True)


def _cfg_kw(kind, class_dropout):
    return dict(model_type=kind, dim=64, n_layer=3, n_head=4, block_size=(IMG // 16) ** 2,
                vocab_size=64, num_classes=10, cls_token_num=8 if kind == "t2i" else 1,
                caption_dim=32, token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0,
                class_dropout_prob=class_dropout)


def _batch(kind, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 64, (B, 16)).astype(np.int32),
             "control_image": rng.integers(0, 255, (B, IMG, IMG, 3)).astype(np.uint8),
             "valid": np.ones((B,), np.float32)}
    if kind == "t2i":
        batch["caption_emb"] = rng.standard_normal((B, 8, 32)).astype(np.float32)
        em = np.ones((B, 8), np.int32)
        em[0, :3] = 0  # left-padded captions
        em[1, :5] = 0
        batch["emb_mask"] = em
    else:
        batch["labels"] = np.array([3, 7], np.int32)
    return batch


def _jax_params(jcfg, jad, seed=1):
    params = {"gpt": jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg),
              "adapter": jvit.init_vit_params(jax.random.PRNGKey(1), jad)}
    # the t2i head is zero at init, which would zero every other gradient
    rng = np.random.default_rng(seed)
    params["gpt"]["output"] = jnp.asarray(
        rng.standard_normal(params["gpt"]["output"].shape) * 0.02, jnp.float32)
    return params


def _to_torch(tree, tcfg, tad):
    """A JAX {gpt, adapter} tree -> {name: tensor} with the ControlModel's names."""
    tree = jax.tree.map(np.asarray, tree)
    model = tcs.ControlModel(convert.gpt_from_jax(tree["gpt"], tcfg),
                             convert.vit_from_jax(tree["adapter"], tad))
    return dict(model.state_dict())


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
    monkeypatch.setattr(jftp, "flash_attention_train_pallas",
                        functools.partial(jftp.flash_attention_train_pallas, interpret=True))


# The attention rounds p and ds to bf16 in both packages (and bf16 compute
# rounds every product), so a different order of fp32 sums can flip one
# rounding and move a gradient element by 2**-8 of one term. Adam's update
# m / sqrt(v) is normalised: where that flips the sign of a small gradient
# the two runs move apart by up to 2 lr a step, which bounds every element;
# the bulk agrees far closer, which the 99.9th percentile holds (measured:
# fp32 <= 0.013 lr, bf16 <= 0.30 lr). Losses agree to fp32 rounding (fp32)
# or to the bf16 rounding of the logits (bf16).
STEP_TOL = {"fp32": dict(loss=2e-5, q999=0.05 * LR), "bf16": dict(loss=1e-3, q999=1.0 * LR)}
STEPS = 3


def _close_after_steps(got, want, tol, what):
    diff = torch.cat([(got[n] - want[n]).abs().flatten() for n in got])
    worst = max(got, key=lambda n: (got[n] - want[n]).abs().max().item())
    assert diff.max().item() <= 2 * LR * STEPS, f"{what}: {worst} off by {diff.max().item()}"
    assert torch.quantile(diff, 0.999).item() <= tol["q999"], what


@pytest.mark.parametrize("kind,dtype,class_dropout",
                         [("c2i", "fp32", 0.0), ("c2i", "bf16", 1.0),
                          ("t2i", "fp32", 1.0), ("t2i", "bf16", 0.0)])
def test_control_step_matches_jax(kind, dtype, class_dropout, pallas_interpret):
    kw = _cfg_kw(kind, class_dropout)
    jcfg, tcfg = JGPTConfig(**kw), GPTConfig(**kw)
    jad, tad = jvit.ViTConfig(**_ADAPTER), tvit.ViTConfig(**_ADAPTER)
    params = _jax_params(jcfg, jad)
    state_dtype = "bfloat16" if dtype == "bf16" else None
    jtx = jopt.make_optimizer(lr=LR, state_dtype=state_dtype)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jtx, params=params, use_ema=True)
    jstep = jax.jit(jmake_step(jcfg, jad, jtx, "canny", ema_decay=0.9,
                               compute_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32))

    model = tcs.ControlModel(convert.gpt_from_jax(params["gpt"], tcfg),
                             convert.vit_from_jax(params["adapter"], tad))
    frozen = topt.frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen[n])
    uncond0 = model.gpt.cls_embedding.state_dict().get("uncond_embedding")
    ttx = topt.make_optimizer(lr=LR, state_dtype=state_dtype)
    tstate = tstep.init_train_state(model, ttx, use_ema=True)
    tfn = tcs.make_control_train_step(tcfg, tad, ttx, "canny", ema_decay=0.9,
                                      compute_dtype=torch.bfloat16 if dtype == "bf16"
                                      else torch.float32)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tol = STEP_TOL[dtype]
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(5))
        tstate, tm = tfn(model, tstate, tb, 5)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=tol["loss"],
                                   err_msg=f"loss, step {i}")
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=100 * tol["loss"], err_msg=f"grad norm, step {i}")
    assert tstate.step == STEPS and tstate.opt_state.count == STEPS
    if state_dtype:
        assert all(m.dtype == torch.bfloat16 for m in tstate.opt_state.mu.values())
    got = {n: p.detach() for n, p in model.named_parameters()}
    _close_after_steps(got, _to_torch(jstate.params, tcfg, tad), tol, "params")
    _close_after_steps(tstate.ema_params, _to_torch(jstate.ema_params, tcfg, tad), tol, "ema")
    if uncond0 is not None:  # the frozen buffer never changes
        assert torch.equal(model.gpt.cls_embedding.uncond_embedding.detach(), uncond0)


def _tiny_trees():
    kw = _cfg_kw("t2i", 0.1)
    jcfg, tcfg = JGPTConfig(**kw), GPTConfig(**kw)
    jad, tad = jvit.ViTConfig(**_ADAPTER), tvit.ViTConfig(**_ADAPTER)
    return _jax_params(jcfg, jad), tcfg, tad


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("grad_scale", [1e-4, 1.0])  # below and above max_grad_norm
def test_adamw_matches_optax(state_dtype, grad_scale):
    """Same gradients -> the same parameters after three steps, to fp32
    rounding (sums in another order, the bias corrections' powers). With
    bf16 moments one ulp of fp32 can flip a moment's bf16 rounding, 2**-8 of
    it, which moves that step's update by at most 2**-8 lr."""
    params, tcfg, tad = _tiny_trees()
    rng = np.random.default_rng(3)
    grads = [jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape) * grad_scale,
                                                jnp.float32), params) for _ in range(3)]
    jtx = jopt.make_optimizer(lr=LR, state_dtype=state_dtype)
    jparams, jst = params, jtx.init(params)
    jupdate = jax.jit(jtx.update)
    tparams = {n: t.clone() for n, t in _to_torch(params, tcfg, tad).items()}
    ttx = topt.make_optimizer(lr=LR, state_dtype=state_dtype)
    tst = ttx.init(tparams)
    for g in grads:
        g = jopt.zero_frozen_grads(g)
        upd, jst = jupdate(g, jst, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        tst, _ = ttx.step(tparams, topt.zero_frozen_grads(_to_torch(g, tcfg, tad), tparams),
                          tst)
    want = _to_torch(jparams, tcfg, tad)
    atol = 1e-8 if state_dtype is None else len(grads) * LR * 2 ** -8
    for n, p in tparams.items():
        np.testing.assert_allclose(p.numpy(), want[n].numpy(), rtol=1e-6, atol=atol, err_msg=n)
    assert torch.equal(tparams["gpt.cls_embedding.uncond_embedding"],
                       _to_torch(params, tcfg, tad)["gpt.cls_embedding.uncond_embedding"])


def test_step_lr_matches_optax():
    sched = topt.step_lr(1e-3, 4, 0.9)
    want = jopt.step_lr(1e-3, 4, 0.9)
    np.testing.assert_allclose([sched(c) for c in range(12)],
                               [float(want(c)) for c in range(12)], rtol=1e-6)


def test_train_step_with_precomputed_features_matches_jax(pallas_interpret):
    """`train/step.make_train_step` (adapter features given, no adapter):
    two fp32 steps against the JAX step, as the control step's bound."""
    from controlar_tpu.train.step import make_train_step as jmake_train_step

    kw = _cfg_kw("t2i", 0.0)
    jcfg, tcfg = JGPTConfig(**kw), GPTConfig(**kw)
    params = _jax_params(jcfg, jvit.ViTConfig(**_ADAPTER))["gpt"]
    rng = np.random.default_rng(6)
    batch = {k: v for k, v in _batch("t2i").items() if k in ("tokens", "caption_emb", "valid")}
    batch["adapter_features"] = (rng.standard_normal((B, 16, 384)) * 0.5).astype(np.float32)
    kv = np.ones((B, 8 + 15), bool)
    kv[0, :3] = False
    batch["key_valid"] = kv
    jtx = jopt.make_optimizer(lr=LR)
    jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jtx, params=params)
    jstep = jax.jit(jmake_train_step(jcfg, jtx, compute_dtype=jnp.float32))
    model = convert.gpt_from_jax(params, tcfg)
    for n, p in model.named_parameters():
        p.requires_grad_(not n.endswith("uncond_embedding"))
    ttx = topt.make_optimizer(lr=LR)
    tstate = tstep.init_train_state(model, ttx)
    tfn = tstep.make_train_step(tcfg, ttx, compute_dtype=torch.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for i in range(2):
        jstate, jm = jstep(jstate, jb, jax.random.PRNGKey(2))
        tstate, tm = tfn(model, tstate, tb, 2)
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]),
                                   rtol=STEP_TOL["fp32"]["loss"], err_msg=f"step {i}")
    want = convert.gpt_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg).state_dict()
    got = {n: p.detach() for n, p in model.named_parameters()}
    diff = torch.cat([(got[n] - want[n]).abs().flatten() for n in got])
    assert diff.max().item() <= 2 * LR * 2
    assert torch.quantile(diff, 0.999).item() <= STEP_TOL["fp32"]["q999"]


def test_decay_mask_matches_jax_rule():
    params, tcfg, tad = _tiny_trees()
    jmask = jopt.decay_mask(params)
    # the JAX mask as constant arrays of the parameters' shapes, converted
    as_arrays = jax.tree.map(lambda p, m: np.full(p.shape, float(m), np.float32), params, jmask)
    want = {n: bool(t.flatten()[0]) for n, t in _to_torch(as_arrays, tcfg, tad).items()}
    got = topt.decay_mask(_to_torch(params, tcfg, tad))
    assert got == want
    # the rule by name: norms and the unconditional caption never decay,
    # the JAX package's stacked per-layer vectors do
    assert not got["gpt.layers.0.attention_norm"] and not got["gpt.norm"]
    assert not got["gpt.cls_embedding.uncond_embedding"]
    assert got["gpt.layers.1.wqkv.weight"] and got["adapter.layers.0.norm1.scale"]
    assert not got["adapter.final_norm.scale"] and not got["adapter.cls_token"]
    assert topt.frozen_mask(got) == {n: n.endswith("uncond_embedding") for n in got}


def test_t2i_masks_and_condition_match_jax():
    from controlar_tpu.train import control_step as jcs

    emb_mask = np.zeros((3, 8), bool)
    for i, n in enumerate((8, 5, 1)):  # left-padded captions
        emb_mask[i, 8 - n:] = True
    np.testing.assert_array_equal(
        tcs.build_t2i_attn_mask(torch.from_numpy(emb_mask), 16).numpy(),
        np.asarray(jcs.build_t2i_attn_mask(jnp.asarray(emb_mask), 16)))
    np.testing.assert_array_equal(
        tcs.t2i_key_valid(torch.from_numpy(emb_mask), 16).numpy(),
        np.asarray(jcs.t2i_key_valid(jnp.asarray(emb_mask), 16)))
    rng = np.random.default_rng(5)
    for batch in ({"control_map": rng.integers(0, 256, (2, 32, 32)).astype(np.uint8)},
                  {"control_image": rng.integers(0, 256, (2, 32, 32, 3)).astype(np.uint8)}):
        got = tcs.extract_condition_on_device({k: torch.from_numpy(v) for k, v in batch.items()},
                                              "canny")
        want = jcs.extract_condition_on_device({k: jnp.asarray(v) for k, v in batch.items()},
                                               "canny")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    # hed and lineart need their frozen network (tests/test_torch_consistency.py
    # holds them to the JAX package); an unknown type raises
    for ct in ("hed", "lineart"):
        with pytest.raises(ValueError, match=ct):
            tcs.extract_condition_on_device({"control_image": torch.zeros(1, 32, 32, 3)}, ct)
    with pytest.raises(ValueError):
        tcs.extract_condition_on_device({"control_image": torch.zeros(1, 32, 32, 3)}, "seg")


def test_dropout_statistics():
    x = torch.ones(200, 500)
    for p in (0.1, 0.5):
        y = tgpt._dropout((1, 2, 3), p, x)
        kept = y != 0
        assert abs(kept.float().mean().item() - (1 - p)) < 5e-3
        assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / (1 - p)))
        assert torch.equal(y, tgpt._dropout((1, 2, 3), p, x))  # the same key, the same mask
        assert not torch.equal(y, tgpt._dropout((1, 2, 4), p, x))
    branch = torch.ones(4000, 3, 5)
    y = tgpt._drop_path((7,), 0.25, branch)
    per_sample = y.reshape(4000, -1)
    assert ((per_sample == 0).all(1) | (per_sample == 1 / 0.75).all(1)).all()
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.75) < 0.03


class _Images:
    """A tiny in-memory t2i dataset: every item the same sample, so that any
    order of batches gives the same steps."""

    def __init__(self, n):
        self.n = n
        self.item = {k: v[0] for k, v in _batch("t2i", seed=4).items()}

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self.item

    def make_batch(self, items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}


def _trainer(tmp_path, name, **kw):
    tcfg = TrainerConfig(
        gpt_model="GPT-B", image_size=IMG, cls_token_num=8, global_batch_size=B, epochs=3,
        results_dir=str(tmp_path / name), log_every=1, ckpt_every=2, lr=LR,
        model_overrides=dict(dim=64, n_layer=3, n_head=4, vocab_size=64, caption_dim=32),
        adapter_override=tvit.ViTConfig(**_ADAPTER), **kw)
    return Trainer(tcfg, device="cpu")


def test_trainer_fit_checkpoint_and_resume(tmp_path):
    loader = ShardedLoader(_Images(6), batch_size=B, num_workers=2)
    full = _trainer(tmp_path, "full", profile_dir=str(tmp_path / "profile"),
                    profile_start_step=2, profile_num_steps=1)
    state = full.fit(loader, max_steps=4)
    assert os.path.exists(tmp_path / "profile" / "trace_step2.json")  # step 3, profiled
    assert state.step == 4
    losses = {r["step"]: r["loss"] for r in full.history}
    assert sorted(losses) == [1, 2, 3, 4] and np.isfinite(list(losses.values())).all()
    assert os.path.exists(os.path.join(full.cfg.results_dir, "metrics.jsonl"))
    assert os.path.exists(os.path.join(full.cfg.results_dir, "log.txt"))

    first = _trainer(tmp_path, "first")
    first.fit(loader, max_steps=2)
    ckpt_dir = os.path.join(first.cfg.results_dir, "checkpoints")
    assert sorted(os.listdir(ckpt_dir)) == ["step_00000002"]
    resumed = _trainer(tmp_path, "resumed", resume_dir=ckpt_dir)
    state = resumed.init_state()
    assert state.step == 2 and state.opt_state.count == 2
    state = resumed.fit(loader, state, max_steps=4)
    assert state.step == 4
    # dropout is on (0.1): its masks are keyed on the step, so the resumed
    # run draws what the uninterrupted one drew
    assert {r["step"]: r["loss"] for r in resumed.history} == {3: losses[3], 4: losses[4]}
    for n, p in resumed.model.named_parameters():
        assert torch.equal(p, dict(full.model.named_parameters())[n]), n
