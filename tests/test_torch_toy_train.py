"""`controlar_tpu_torch.toy_train` against the JAX package's
`scripts/toy_train_quant.py` and train step, on the CPU at tiny widths.

- The task generators and the batch stream are the script's, array for
  array.
- Toy steps: the losses of N steps equal the JAX step's within 2e-5
  relative (fp32 compute and Adam moments, class dropout 0 since each
  package draws it from its own RNG; the JAX training attention runs its
  Pallas kernel in interpret mode, whose rounding of p and ds to bf16 the
  port's plain version computes too).
- With the toy configuration's class dropout (0.1) only the port runs, and
  the loss must fall.
"""
import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from controlar_tpu import config as jconfig
from controlar_tpu.models import gpt as jgpt
from controlar_tpu.ops import flash_train_pallas as jftp
from controlar_tpu.train import optimizer as jopt
from controlar_tpu.train.step import init_train_state as jinit_state
from controlar_tpu.train.step import make_train_step as jmake_train_step
from controlar_tpu_torch import convert
from controlar_tpu_torch import toy_train

REPO = Path(__file__).resolve().parents[1]
TINY = dict(dim=64, n_layer=3, n_head=4, vocab_size=1024, num_classes=16)  # > CHAIN_STATES


@functools.lru_cache(maxsize=None)
def _script():
    spec = importlib.util.spec_from_file_location("toy_train_quant",
                                                  REPO / "scripts" / "toy_train_quant.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def pallas_interpret(monkeypatch):
    monkeypatch.setenv("CONTROLAR_TRAIN_BLOCKWISE", "pallas")
    monkeypatch.setattr(jftp, "flash_attention_train_pallas",
                        functools.partial(jftp.flash_attention_train_pallas, interpret=True))


@pytest.mark.parametrize("task", ["basic", "chain"])
@pytest.mark.parametrize("seed", [0, 3])
def test_task_generators_match_the_script(task, seed):
    script = _script()
    want_fn = script.toy_tokens if task == "basic" else script.toy_tokens_chain
    labels = np.random.default_rng(seed).integers(0, 16, 8)
    for noise in (0.1, 0.25):
        want = want_fn(np.random.default_rng(seed), labels, 64, 16384, noise)
        got = toy_train.TASKS[task](np.random.default_rng(seed), labels, 64, 16384, noise)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert toy_train.CHAIN_STATES == script.CHAIN_STATES


@pytest.mark.parametrize("task", ["basic", "chain"])
def test_batch_stream_is_the_scripts(task):
    """The script's loop: one numpy generator seeded 0, labels then tokens."""
    script = _script()
    cfg = toy_train.toy_config("GPT-B", 36)
    fn = script.toy_tokens if task == "basic" else script.toy_tokens_chain
    noise = 0.1 if task == "basic" else 0.25
    rng = np.random.default_rng(0)
    stream = toy_train.toy_batches(task, cfg, 4, 16, noise)
    for _ in range(3):
        labels = rng.integers(0, 16, 4)
        tokens = fn(rng, labels, cfg.block_size, cfg.vocab_size, noise)
        got = next(stream)
        np.testing.assert_array_equal(got["labels"], labels.astype(np.int32))
        np.testing.assert_array_equal(got["tokens"], tokens)


@pytest.mark.parametrize("size", ["GPT-B", "GPT-XL", "GPT-3B"])
def test_toy_config_is_the_scripts(size):
    """The script's c2i configuration (toy_train_quant.py:111-114)."""
    want = jconfig.gpt_config(size, model_type="c2i", cls_token_num=1, block_size=256,
                              vocab_size=16384, num_classes=1000, class_dropout_prob=0.1,
                              token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0)
    got = toy_train.toy_config(size, 256)
    for field in ("dim", "n_layer", "n_head", "n_kv_head", "vocab_size", "num_classes",
                  "block_size", "cls_token_num", "class_dropout_prob", "token_dropout_p",
                  "resid_dropout_p", "ffn_dropout_p", "model_type", "ffn_hidden_dim"):
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("task", ["basic", "chain"])
def test_toy_steps_match_jax(task, pallas_interpret):
    steps, batch, lr = 4, 4, 3e-3
    kw = dict(TINY, class_dropout_prob=0.0)
    jcfg = jconfig.gpt_config("GPT-B", model_type="c2i", cls_token_num=1, block_size=16,
                              token_dropout_p=0.0, resid_dropout_p=0.0, ffn_dropout_p=0.0, **kw)
    tcfg = toy_train.toy_config("GPT-B", 16, **kw)
    params = jgpt.init_gpt_params(jax.random.PRNGKey(0), jcfg)
    model = convert.gpt_from_jax(jax.tree.map(np.asarray, params), tcfg)
    res = toy_train.train(tcfg, steps=steps, batch=batch, lr=lr, task=task, model=model,
                          opt_state_dtype="float32", compute_dtype=torch.float32,
                          device="cpu", log=lambda msg: None)

    tx = jopt.make_optimizer(lr=lr)
    state = jinit_state(jax.random.PRNGKey(0), jcfg, tx, params=params)
    step = jax.jit(jmake_train_step(jcfg, tx, compute_dtype=jnp.float32))
    stream = toy_train.toy_batches(task, tcfg, batch, 16, 0.1 if task == "basic" else 0.25)
    want = []
    for _ in range(steps):
        b = {k: jnp.asarray(v) for k, v in next(stream).items()}
        state, m = step(state, b, jax.random.PRNGKey(1))
        want.append(float(m["loss"]))
    np.testing.assert_allclose(res["step_losses"], want, rtol=2e-5)
    assert res["losses"] == [res["step_losses"][0], res["step_losses"][-1]]


def test_loss_falls_with_class_dropout():
    cfg = toy_train.toy_config("GPT-B", 16, **TINY)
    assert cfg.class_dropout_prob == 0.1
    res = toy_train.train(cfg, steps=30, batch=8, lr=3e-3, device="cpu", log=lambda msg: None)
    losses = res["step_losses"]
    assert np.isfinite(losses).all() and np.mean(losses[-5:]) < 0.8 * losses[0]
    assert all(not p.requires_grad for p in res["model"].parameters())


def test_cli_trains_saves_and_reloads(tmp_path, monkeypatch):
    """`python -m controlar_tpu_torch.toy_train` on the CPU at tiny widths:
    train with a mid-training snapshot, save, report; then --load-ckpt on
    the saved model reports the same numbers."""
    monkeypatch.setattr(toy_train, "toy_config",
                        lambda size, block_size: toy_train.gpt_config(
                            size, model_type="c2i", cls_token_num=1, block_size=block_size,
                            class_dropout_prob=0.1, **{**TINY, "dim": 128, "n_head": 2}))
    common = ["--block-size", "16", "--max-new-tokens", "16", "--quant-modes", "int8,w4+kv4",
              "--device", "cpu"]
    out = tmp_path / "run.json"
    assert toy_train.main(["--steps", "6", "--batch", "4", "--mid-ckpt-frac", "0.5",
                           "--ckpt-out", str(tmp_path / "ckpt"), "--json-out", str(out),
                           *common]) == 0
    run = json.loads(out.read_text())
    assert run["steps"] == 6 and run["mid_step"] == 3 and len(run["losses"]) == 2
    assert set(run["quant_report"]) == set(run["quant_report_mid"]) == {"int8", "w4+kv4"}
    assert 1 <= run["spec_int8_self_draft"]["accepted_per_cycle"] <= 4
    assert (tmp_path / "ckpt" / "step_00000006").is_dir()
    assert (tmp_path / "ckpt_mid" / "step_00000003").is_dir()
    again = tmp_path / "again.json"
    assert toy_train.main(["--load-ckpt", str(tmp_path / "ckpt"), "--json-out", str(again),
                           *common]) == 0
    assert json.loads(again.read_text())["quant_report"] == run["quant_report"]


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_groups_give_one_pass_bit_for_bit(monkeypatch, state_dtype):
    """AdamW updates in groups of CHUNK_ELEMENTS (bounded temporaries at
    GPT-3B): any grouping gives the same parameters and moments."""
    from controlar_tpu_torch.train import optimizer as topt

    gen = torch.Generator().manual_seed(0)
    shapes = {"a.weight": (7, 5), "b.norm": (5,), "layers.0.w": (3, 4), "c.weight": (9, 2)}
    runs = []
    for chunk in (1 << 28, 20, 1):
        monkeypatch.setattr(topt, "CHUNK_ELEMENTS", chunk)
        params = {n: torch.randn(s, generator=torch.Generator().manual_seed(1)) for n, s in
                  shapes.items()}
        tx = topt.make_optimizer(lr=1e-2, state_dtype=state_dtype)
        state = tx.init(params)
        for _ in range(3):
            grads = {n: torch.randn(p.shape, generator=gen) * 2 for n, p in params.items()}
            state, norm = tx.step(params, grads, state)
        runs.append((params, state))
        gen.manual_seed(0)
    for params, state in runs[1:]:
        for n in shapes:
            assert torch.equal(params[n], runs[0][0][n]), n
            assert torch.equal(state.mu[n], runs[0][1].mu[n])
            assert torch.equal(state.nu[n], runs[0][1].nu[n])
