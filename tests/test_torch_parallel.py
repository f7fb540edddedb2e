"""The port's parallel layer (`controlar_tpu_torch/parallel/`) against one
process and against the JAX package, on the CPU over gloo.

- the mesh, the tensor-parallel plan and the rank's configuration;
- tp = 2 greedy `generate` token for token against the one-process run and
  the JAX package's `generate` on the same weights, fp32 and W8 + int8
  cache (the JAX package's own check is `tests/test_tp_inference.py`);
- a control train step over (data 2), (fsdp 2) and (tp 2) against one
  process on the whole batch and against the JAX package's step; under
  fsdp 2 each rank keeps half the Adam moments;
- `Trainer.fit` under fsdp 2, its checkpoint restored into a one-process
  Trainer.

The processes are spawned by `tests/torch_parallel_workers.py` (torch only),
each case under its own timeout.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from controlar_tpu import generate as jgen
from controlar_tpu import quant as jquant
from controlar_tpu.config import GPTConfig as JGPTConfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.models import vit as jvit
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu.train import optimizer as jopt
from controlar_tpu.train.control_step import make_control_train_step as jmake_step
from controlar_tpu.train.step import init_train_state as jinit_state
from controlar_tpu_torch import convert
from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import checkpoint as ckpt_lib
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.parallel import distributed
from controlar_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from controlar_tpu_torch.parallel.sharding import (
    ShardLayout,
    TPSpec,
    gpt_tp_specs,
    rank_config,
    tp_slice,
    tp_unslice,
)
from controlar_tpu_torch.quant import quantize_gpt
from controlar_tpu_torch.train import control_step as tcs
from controlar_tpu_torch.train import optimizer as topt
from controlar_tpu_torch.train import step as tstep
from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig
from tests import torch_parallel_workers as workers

# ---------------------------------------------------------------------------
# The mesh and the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,axes,want", [
    (8, (-1, 2, 2), (2, 2, 2)), (4, (-1, 1, 1), (4, 1, 1)), (2, (1, 1, 2), (1, 1, 2)),
    (1, (-1, 1, 1), (1, 1, 1))])
def test_mesh_shape(world, axes, want):
    assert mesh_shape(world, *axes) == want


@pytest.mark.parametrize("world,axes", [(4, (-1, 3, 1)), (4, (2, 1, 1)), (2, (1, 1, 4))])
def test_mesh_shape_refuses_a_wrong_product(world, axes):
    with pytest.raises(ValueError):
        mesh_shape(world, *axes)


def test_one_process_mesh_and_init_are_noops(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "SLURM_PROCID", "SLURM_NTASKS"):
        monkeypatch.delenv(k, raising=False)
    distributed.init()
    assert not torch.distributed.is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_main_process()
    mesh = make_mesh()
    assert mesh.shape == (1, 1, 1) and mesh.coords == (0, 0, 0)
    assert all(g is None for g in mesh.groups.values())
    with pytest.raises(ValueError, match="together"):
        distributed.init(coordinator_address="127.0.0.1:1")


@pytest.mark.parametrize("shape", [(2, 1, 2), (1, 2, 2), (-1, 2, 1)])
def test_mesh_groups_over_four_processes(shape):
    """Rank r sits at (d, f, t) with r = (d * fsdp + f) * tp + t; each axis's
    group holds the ranks that differ from r on that axis alone, "dp" those
    that share r's tp index."""
    res = workers.run(workers.mesh_groups, 4, shape)
    full = mesh_shape(4, *shape)
    nd, nf, nt = full
    for r, (coords, groups) in enumerate(res):
        d, f, t = coords
        assert r == (d * nf + f) * nt + t
        members = {"data": [(i * nf + f) * nt + t for i in range(nd)],
                   "fsdp": [(d * nf + i) * nt + t for i in range(nf)],
                   "tp": [(d * nf + f) * nt + i for i in range(nt)],
                   "dp": [(i * nf + j) * nt + t for i in range(nd) for j in range(nf)]}
        for axis, want in members.items():
            assert groups[axis] == (want if len(want) > 1 else None), (r, axis)


def test_rank_config_keeps_the_head_width():
    cfg = GPTConfig(dim=768, n_layer=2, n_head=12)
    rc = rank_config(cfg, 2)
    assert (rc.n_head, rc.kv_heads, rc.head_dim, rc.dim) == (6, 6, 64, 768)
    assert rc.ffn_hidden_dim * 2 == cfg.ffn_hidden_dim
    assert rank_config(cfg, 1) is cfg
    with pytest.raises(ValueError):
        rank_config(GPTConfig(dim=64, n_layer=2, n_head=3), 2)


def test_tp_plan_splits_heads_by_section():
    cfg = GPTConfig(dim=64, n_layer=3, n_head=4, model_type="t2i", caption_dim=32)
    names = [n for n, _ in tgpt.GPT(cfg).named_parameters()]
    specs = gpt_tp_specs(cfg, names)
    split = {n.split(".")[-2] if n.startswith("layers") else n.rsplit(".", 1)[0]
             for n in specs}
    assert split == {"wqkv", "wo", "w1", "w3", "w2", "adapter_mlp.fc1", "adapter_mlp.fc2",
                     "condition_mlp.fc1", "condition_mlp.fc2", "cls_embedding.fc1",
                     "cls_embedding.fc2", "condition_layers.0.fc1", "condition_layers.0.fc2",
                     "condition_layers.1.fc1", "condition_layers.1.fc2",
                     "condition_layers.2.fc1", "condition_layers.2.fc2"}
    assert not any(k in n for n in specs for k in ("tok_embeddings", "output", "norm"))
    spec = specs["layers.0.wqkv.weight"]
    assert spec == TPSpec(0, (64, 64, 64), "column")
    # rank r's rows: its heads of q, of k and of v
    w = torch.arange(192.0)[:, None].expand(192, 5)
    parts = [tp_slice(w, spec, r, 2) for r in range(2)]
    assert parts[0][:, 0].tolist() == (list(range(0, 32)) + list(range(64, 96))
                                       + list(range(128, 160)))
    assert torch.equal(tp_unslice(parts, spec), w)


def test_layout_pieces_round_trip_in_one_process():
    mesh = make_mesh()
    layout = ShardLayout(mesh, {"a": torch.Size([5, 3])}, {})
    t = {"a": torch.randn(5, 3)}
    assert torch.equal(layout.unshard(layout.shard(t))["a"], t["a"])


# ---------------------------------------------------------------------------
# Tensor-parallel decode
# ---------------------------------------------------------------------------

GEN_CFG = dict(model_type="c2i", dim=64, n_layer=4, n_head=4, cls_token_num=1, block_size=16,
               vocab_size=128, num_classes=10, adapter_size="small")
MARGIN = 1e-4  # greedy tokens may part only where the top two logits are this close


def _first_parting(got, want, logits):
    """Each row's first position where got and want part must be a near
    tie of the reference's logits there (`logits[i]`: (B, V) at token i)."""
    for b in range(want.shape[0]):
        diff = np.nonzero(got[b] != want[b])[0]
        if len(diff):
            i = diff[0]
            top2 = torch.topk(logits[i][b], 2).values
            assert (top2[0] - top2[1]).item() < MARGIN * logits[i].abs().max().item(), \
                f"row {b} parts at token {i} with a clear margin"


def _port_with_logits(model, cfg, monkeypatch, **kw):
    """One-process greedy generate, recording the CFG-mixed logits."""
    seen = []
    real = tgen.sample_from

    def record(logits, *a, **k):
        seen.append(logits.clone())
        return real(logits, *a, **k)

    monkeypatch.setattr(tgen, "sample_from", record)
    toks = tgen.generate(model, cfg, device="cpu", **kw).numpy()
    monkeypatch.setattr(tgen, "sample_from", real)
    return toks, seen


@pytest.mark.parametrize("quant", [False, True])
def test_tp2_generate_matches_one_process_and_jax(quant, monkeypatch):
    jcfg, cfg = JGPTConfig(**GEN_CFG), GPTConfig(**GEN_CFG)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    model = convert.gpt_from_jax(jax.tree.map(np.asarray, params), cfg)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    feats = (np.random.default_rng(1).standard_normal((4, 16, 384)) * 0.5).astype(np.float32)
    gen_kw = dict(labels=np.arange(4), adapter_features=feats, max_new_tokens=16,
                  cfg_scale=2.0, sample_logits=False, cache_dtype=torch.float32)

    got = workers.run(workers.tp_generate, 2, (1, 1, 2), GEN_CFG, sd, quant, gen_kw)
    np.testing.assert_array_equal(got[0], got[1])  # every rank draws the same tokens

    one_kw = dict(gen_kw)
    jkw = dict(labels=jnp.arange(4), adapter_features=jnp.asarray(feats), max_new_tokens=16,
               cfg_scale=2.0, sample_logits=False, rng=jax.random.PRNGKey(1), use_flash=False,
               cache_dtype=jnp.float32)
    jparams = params
    if quant:
        quantize_gpt(model, cfg, "int8")
        one_kw["cache_dtype"] = torch.int8
        jparams = jquant.quantize_gpt_params(params)
        jkw["cache_dtype"] = jnp.int8
    one, logits = _port_with_logits(model, cfg, monkeypatch, **one_kw)
    want_jax = np.asarray(jgen.generate(jparams, jcfg, **jkw))
    _first_parting(got[0], one, logits)
    _first_parting(one, want_jax, logits)


# ---------------------------------------------------------------------------
# Control train steps over the mesh
# ---------------------------------------------------------------------------

IMG, B, LR = 64, 4, 1e-3
STEP_CFG = dict(model_type="c2i", dim=64, n_layer=3, n_head=4, block_size=16, vocab_size=64,
                num_classes=10, cls_token_num=1, caption_dim=32, token_dropout_p=0.0,
                resid_dropout_p=0.0, ffn_dropout_p=0.0, class_dropout_prob=0.0)
ADAPTER = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4, layerscale=True)


def _step_batches():
    """Two batches: every row weighing one, and one row weighing nothing."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, 64, (B, 16)).astype(np.int32),
             "control_image": rng.integers(0, 255, (B, IMG, IMG, 3)).astype(np.uint8),
             "valid": np.ones(B, np.float32), "labels": np.array([3, 7, 1, 2], np.int32)}
    return {"ones": batch, "dropped": dict(batch, valid=np.array([1, 1, 0, 1], np.float32))}


def _one_process_step(tree, cfg, tad, batch):
    """One port process on the whole batch: one fp32 control step. ->
    {loss, grad_norm, grads (before the clip), params, moment_bytes}."""
    model = tcs.ControlModel(convert.gpt_from_jax(tree["gpt"], cfg),
                             convert.vit_from_jax(tree["adapter"], tad))
    frozen = topt.frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen[n])
    tx = topt.make_optimizer(lr=LR)
    grads = workers.record_first_grads(tx)
    state = tstep.init_train_state(model, tx, use_ema=True)
    fn = tcs.make_control_train_step(cfg, tad, tx, "canny", ema_decay=0.9,
                                     compute_dtype=torch.float32)
    state, m = fn(model, state, {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    return dict(loss=m["loss"].item(), grad_norm=m["grad_norm"].item(), grads=grads,
                params={n: p.detach().clone() for n, p in state.params.items()},
                moment_bytes=sum(t.numel() * t.element_size() for d in
                                 (state.opt_state.mu, state.opt_state.nu) for t in d.values()))


@pytest.fixture(scope="module")
def step_reference():
    """Per batch of `_step_batches`: the JAX step ("jax": loss, grad_norm,
    params) and one port process on the whole batch, with the attention as
    the kernels round it ("rounded") and exact ("exact")."""
    jcfg, cfg = JGPTConfig(**STEP_CFG), GPTConfig(**STEP_CFG)
    jad, tad = jvit.ViTConfig(**ADAPTER), tvit.ViTConfig(**ADAPTER)
    params = {"gpt": jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg),
              "adapter": jvit.init_vit_params(jax.random.PRNGKey(1), jad)}
    tree = jax.tree.map(np.asarray, params)
    sd = dict(tcs.ControlModel(convert.gpt_from_jax(tree["gpt"], cfg),
                               convert.vit_from_jax(tree["adapter"], tad)).state_dict())
    out = {"sd": sd, "batches": _step_batches()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
        mp.setattr(jftp, "flash_attention_train_pallas",
                   functools.partial(jftp.flash_attention_train_pallas, interpret=True))
        jtx = jopt.make_optimizer(lr=LR)
        jstep = jax.jit(jmake_step(jcfg, jad, jtx, "canny", ema_decay=0.9,
                                   compute_dtype=jnp.float32))
        for name, batch in out["batches"].items():
            jstate = jinit_state(jax.random.PRNGKey(0), jcfg, jtx, params=params, use_ema=True)
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(5))
            jt = jax.tree.map(np.asarray, jstate.params)
            jax_params = dict(tcs.ControlModel(convert.gpt_from_jax(jt["gpt"], cfg),
                                               convert.vit_from_jax(jt["adapter"], tad))
                              .state_dict())
            out[name] = {"jax": dict(loss=float(jm["loss"]), grad_norm=float(jm["grad_norm"]),
                                     params=jax_params),
                         "rounded": _one_process_step(tree, cfg, tad, batch)}
            with workers.exact_attention():
                out[name]["exact"] = _one_process_step(tree, cfg, tad, batch)
    return out


def _grads_close(got, want, what):
    """The whole gradients, leaf by leaf: each within 1e-5 of its leaf's
    largest. A leaf whose gradient is zero in exact arithmetic holds only
    rounding noise (the attention keys' bias: softmax does not see a shift
    common to all keys), so a leaf's scale is at least 1e-6 of the model's
    largest gradient."""
    floor = 1e-6 * max(w.abs().max().item() for w in want.values())
    for n, w in want.items():
        scale = max(w.abs().max().item(), floor)
        err = (got[n] - w).abs().max().item()
        assert err <= 1e-5 * scale, f"{what}: gradient of {n} off by {err} (scale {scale})"


def _params_close(got, want, bound, mean_bound, what):
    """Parameters after one AdamW step, leaf by leaf: every element within
    `bound`, and each leaf's mean difference within `mean_bound`."""
    for n, w in want.items():
        diff = (got[n] - w).abs()
        assert diff.max().item() <= bound, f"{what}: {n} off by {diff.max().item()}"
        assert diff.mean().item() <= mean_bound, f"{what}: {n} off by {diff.mean().item()} " \
                                                 "on the mean"


@pytest.mark.parametrize("mesh", [(2, 1, 1), (1, 2, 1), (1, 1, 2)], ids=["data2", "fsdp2", "tp2"])
def test_control_step_over_the_mesh(mesh, step_reference):
    """One control step over the mesh, on a batch whose rows all weigh one
    and on one with a row weighing nothing (a rank's loss weight is then
    2 / 3 or 1 / 3 of the whole).

    With the attention exact (`workers.exact_attention`), against one
    process on the whole batch: every rank's loss and gradient norm within
    1e-5, the reduced gradients leaf by leaf within 1e-5 of the leaf's
    largest. This holds the sums over the shards, the loss weights and the
    global-norm clip. Adam's first update is about sign(g) lr, so an element
    whose gradient is within the sums' rounding of zero may move by up to
    2 lr; each leaf's mean difference stays within 1e-5 of the largest
    parameter (a leaf left as it was is off by about lr on the mean).

    With the attention rounding q, k, v, p and ds to bf16 (as the JAX
    package's kernel does), against the JAX step: the loss within 2e-5 and
    the gradient norm within 1e-5. A sum taken in another order (tp's
    all-reduce) or a gradient scaled by a rank's share (1 / 2 instead of
    1 / 3) lands a term on another bf16 value, 2**-8 away: with a row
    dropped the norm is held to 2**-8, and the parameters to 2 lr an
    element and 0.01 lr on each leaf's mean."""
    ref = step_reference
    runs = {}
    for name, batch in ref["batches"].items():
        runs[name], runs[name + "/exact"] = (batch, False), (batch, True)
    res = workers.run(workers.control_step, 2, mesh, "c2i", STEP_CFG, ADAPTER, ref["sd"],
                      runs, LR, 1)
    for name in ref["batches"]:
        want, got = ref[name]["exact"], [r[name + "/exact"] for r in res]
        scale = max(p.abs().max().item() for p in want["params"].values())
        for r in got:
            np.testing.assert_allclose(r["loss"][0], want["loss"], rtol=1e-5)
            np.testing.assert_allclose(r["grad_norm"][0], want["grad_norm"], rtol=1e-5)
        _grads_close(got[0]["grads"], want["grads"], f"{name}, exact")
        _params_close(got[0]["params"], want["params"], 2 * LR * (1 + 1e-3), 1e-5 * scale,
                      f"{name}, exact")

        jax_ref, got = ref[name]["jax"], [r[name] for r in res]
        for r in got:
            np.testing.assert_allclose(r["loss"][0], ref[name]["rounded"]["loss"], rtol=1e-5)
            np.testing.assert_allclose(r["loss"][0], jax_ref["loss"], rtol=2e-5)
            np.testing.assert_allclose(r["grad_norm"][0], jax_ref["grad_norm"],
                                       rtol=1e-5 if name == "ones" else 2**-8)
        _params_close(got[0]["params"], jax_ref["params"], 2 * LR * (1 + 1e-3), 0.01 * LR,
                      f"{name}: the JAX step")
    one = ref["ones"]["exact"]["moment_bytes"]
    per_rank = [r["ones"]["moment_bytes"] for r in res]
    if mesh == (1, 2, 1):  # fsdp: each rank keeps half of every moment (dim 0 rounded up)
        half = sum(-(-p.shape[0] // 2) * p[0].numel() * 4 * 2
                   for p in ref["ones"]["exact"]["params"].values())
        assert per_rank == [half, half] and half <= 0.51 * one
    elif mesh == (1, 1, 2):  # tp: the split weights' moments are halved, the rest whole
        assert 0.5 * one < per_rank[0] == per_rank[1] < one
    else:
        assert per_rank == [one, one]


# ---------------------------------------------------------------------------
# The trainer over fsdp 2, and its checkpoint on one process
# ---------------------------------------------------------------------------

def _trainer_kw(fsdp):
    return dict(gpt_model="GPT-B", model_type="c2i", image_size=IMG, cls_token_num=1,
                vocab_size=64, dropout_p=0.0, global_batch_size=4, epochs=1, log_every=1,
                ckpt_every=1000, fsdp_axis=fsdp, lr=LR,
                model_overrides=dict(dim=64, n_layer=3, n_head=4, num_classes=10),
                adapter_override=tvit.ViTConfig(**ADAPTER))


def test_trainer_fsdp2_checkpoint_restores_on_one_process(tmp_path):
    data = dict(n=8, tokens=16, image_px=IMG, vocab=64, classes=10)
    res = workers.run(workers.trainer_checkpoint, 2, _trainer_kw(2), str(tmp_path / "run"),
                      data, 2)
    path = res[0]["path"]
    assert path and res[1]["path"] is None  # rank 0 alone writes
    assert [h["loss"] for h in res[0]["history"]] == [h["loss"] for h in res[1]["history"]]

    one = Trainer(TrainerConfig(results_dir=str(tmp_path / "one"), **_trainer_kw(1)),
                  device="cpu")
    assert one.mesh is None and one.batch_split() == (0, 1)
    state = ckpt_lib.restore_train_state(path, one.init_state())
    saved = torch.load(path + "/state.pt", weights_only=True)
    assert state.step == 2 and state.opt_state.count == 2
    for n, p in state.params.items():
        assert torch.equal(p.detach(), saved["params"][n]), n
        assert state.opt_state.mu[n].shape == p.shape
    # the whole moments: twice a rank's pieces, less the padding of odd rows
    whole = sum(t.numel() * 4 for d in (state.opt_state.mu, state.opt_state.nu)
                for t in d.values())
    assert whole <= 2 * res[0]["moment_bytes"] <= whole * 1.02
    # it trains on from there on one process
    ds = workers.TinyControlDataset(**data)
    state = one.fit(_OneEpoch([ds.make_batch([ds[i] for i in range(4)])]), state=state,
                    max_steps=3)
    assert state.step == 3 and np.isfinite(one.history[-1]["loss"])


class _OneEpoch(list):
    def set_epoch(self, epoch):
        pass
