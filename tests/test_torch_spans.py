"""The port's profiler spans (`controlar_tpu_torch/spans.py`), on the CPU.

- with no profiler recording, `span` never opens a profiler
  range, in the span itself and through a generate call and a training
  step;
- under `torch.profiler`, a tiny `ControlARPipeline.generate` records one
  `decode.step` per decode step holding one `decode.sample`,
  `decode.logits`, the fusion layers' `decode.fuse` and every layer's
  `decode.attn` / `decode.ffn`, properly nested, and nothing outside the
  steps, and returns the images and tokens of an unprofiled call;
- a tiny `Trainer.fit` step under the profiler (an outer one, or the
  Trainer's own `profile_dir` window) records `train.data`,
  `train.forward` holding `train.condition` and `train.adapter`,
  `train.backward` and `train.update`, once each and in order, and its loss
  is an unprofiled step's;
- `Trainer.fit`'s log window reads the monotonic clock.
"""
import json
import re
import types

import numpy as np
import pytest
import torch

from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch import spans
from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.models import gpt as tgpt
from controlar_tpu_torch.models import vit as tvit
from controlar_tpu_torch.models import vq as tvq
from controlar_tpu_torch.pipeline import ControlARPipeline
from controlar_tpu_torch.train import trainer as trainer_mod
from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

IMG, B = 32, 2
_ADAPTER = dict(hidden_size=384, n_layer=1, n_head=2, patch_size=14, pos_grid=4)


_PROGRAM_SPAN = re.compile(r"^(gen|decode|train)\.[a-z_]+$")


def _no_range(*a, **k):
    raise AssertionError("profiler range opened with no profiler recording")


def _forbid_ranges(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", _no_range)


def _profiled(fn, tmp_path):
    """fn() under torch.profiler on the CPU -> (its result, the program's
    spans [(name, start, end)] in time order, from the exported trace)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return out, _trace_spans(path)


def _trace_spans(path):
    events = json.loads(path.read_text())["traceEvents"]
    got = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
           if "dur" in e and _PROGRAM_SPAN.match(e["name"])]
    return sorted(got, key=lambda s: (s[1], -s[2]))


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _children(spans_, outer, name):
    return [s for s in spans_ if s[0] == name and _inside(s, outer)]


def _pipeline(model_type="c2i"):
    cfg = GPTConfig(model_type=model_type, dim=64, n_layer=3, n_head=4, vocab_size=96,
                    num_classes=10, caption_dim=24, block_size=(IMG // 16) ** 2,
                    cls_token_num=1 if model_type == "c2i" else 6)
    vcfg = VQConfig(codebook_size=96, codebook_embed_dim=8, z_channels=16, ch=16)
    ad_cfg = tvit.ViTConfig(**_ADAPTER)
    pipe = ControlARPipeline(gpt_cfg=cfg, gpt=tgpt.init_gpt(cfg, seed=0, device="cpu"),
                             vq_cfg=vcfg, vq=tvq.init_vq(vcfg, seed=1, device="cpu"),
                             adapter_cfg=ad_cfg, adapter=tvit.init_vit(ad_cfg, seed=2,
                                                                       device="cpu"),
                             device="cpu")
    rng = np.random.default_rng(0)
    kw = dict(cfg_scale=4.0, top_k=5, seed=3,
              condition_images=rng.integers(0, 256, (B, IMG, IMG, 3)).astype(np.uint8))
    if model_type == "c2i":
        kw["labels"] = np.array([3, 7])
    else:
        kw["caption_emb"] = torch.as_tensor(rng.standard_normal((B, 6, 24)), dtype=torch.float32)
        kw["emb_masks"] = torch.as_tensor([[0, 0, 1, 1, 1, 1], [1, 1, 1, 1, 1, 1]])
    return pipe, kw


def _capture_tokens(monkeypatch):
    got = []
    real = tgen.generate

    def generate(*a, **k):
        out = real(*a, **k)
        got.append(out)
        return out

    monkeypatch.setattr(tgen, "generate", generate)
    return got


def test_span_without_a_profiler_opens_no_range(monkeypatch):
    _forbid_ranges(monkeypatch)
    assert not torch._C._autograd._profiler_enabled()
    first, second = spans.span("decode.step"), spans.span("train.update")
    assert first is second
    with first:
        with second:
            pass


def test_span_under_a_profiler_is_recorded(tmp_path):
    def fn():
        with spans.span("decode.step"):
            with spans.span("decode.sample"):
                return torch.ones(3).sum()

    _, got = _profiled(fn, tmp_path)
    assert [s[0] for s in got] == ["decode.step", "decode.sample"]
    assert _inside(got[1], got[0])


def test_unprofiled_generate_and_step_open_no_range(monkeypatch, tmp_path):
    pipe, kw = _pipeline()
    _forbid_ranges(monkeypatch)
    imgs = pipe.generate(**kw, timings={})
    assert imgs.shape == (B, IMG, IMG, 3)
    trainer = _trainer(tmp_path)
    state = trainer.fit(_Loader(1), max_steps=1)
    assert state.step == 1


@pytest.mark.parametrize("model_type", ["c2i", "t2i"])
def test_generate_spans_nest_and_leave_the_call_unchanged(model_type, monkeypatch, tmp_path):
    pipe, kw = _pipeline(model_type)
    tokens = _capture_tokens(monkeypatch)
    want = pipe.generate(**kw)
    timings = {}
    got, sp = _profiled(lambda: pipe.generate(**kw, timings=timings), tmp_path)
    np.testing.assert_array_equal(got, want)
    torch.testing.assert_close(tokens[1], tokens[0], rtol=0, atol=0)
    assert list(timings) == ["condition", "adapter", "tokens", "vq_decode"]

    cfg = pipe.gpt_cfg
    steps = [s for s in sp if s[0] == "decode.step"]
    assert len(steps) == cfg.block_size - 1
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))
    n_fuse = int(tgpt._fusion_gates(cfg)[0].sum())
    for step in steps:
        assert len(_children(sp, step, "decode.sample")) == 1
        assert len(_children(sp, step, "decode.logits")) == 1
        assert len(_children(sp, step, "decode.fuse")) == n_fuse
        attn = _children(sp, step, "decode.attn")
        ffn = _children(sp, step, "decode.ffn")
        assert len(attn) == len(ffn) == cfg.n_layer
        # each layer's attention ends before its FFN starts
        assert all(a[2] <= f[1] for a, f in zip(attn, ffn))
    # no span outside the steps: the prefill and the pipeline's stages record none
    assert all(any(_inside(s, o) for o in steps) for s in sp)
    assert {s[0] for s in sp} == {"decode.step", "decode.sample", "decode.logits",
                                  "decode.fuse", "decode.attn", "decode.ffn"}


class _Loader:
    """The trainer's loader protocol over one fixed batch, `n` times."""

    def __init__(self, n):
        rng = np.random.default_rng(4)
        em = np.ones((B, 8), np.int32)
        em[0, :3] = 0
        self.batch = {"tokens": rng.integers(0, 64, (B, 16)).astype(np.int32),
                      "control_image": rng.integers(0, 255, (B, 64, 64, 3)).astype(np.uint8),
                      "caption_emb": rng.standard_normal((B, 8, 32)).astype(np.float32),
                      "emb_mask": em, "valid": np.ones((B,), np.float32)}
        self.n = n

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter([self.batch] * self.n)


def _trainer(tmp_path, name="run", **kw):
    kw = dict(dict(log_every=10 ** 9), **kw)
    tcfg = TrainerConfig(
        gpt_model="GPT-B", image_size=64, cls_token_num=8, global_batch_size=B, epochs=1,
        results_dir=str(tmp_path / name), ckpt_every=10 ** 9, lr=1e-3,
        model_overrides=dict(dim=64, n_layer=3, n_head=4, vocab_size=64, caption_dim=32),
        adapter_override=tvit.ViTConfig(**_ADAPTER), **kw)
    return Trainer(tcfg, device="cpu")


_TRAIN_ORDER = ["train.data", "train.forward", "train.backward", "train.update"]


def _check_train_step(sp):
    top = [s for s in sp if s[0] in _TRAIN_ORDER]
    assert [s[0] for s in top] == _TRAIN_ORDER
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))
    inner = [s for s in sp if s[0] in ("train.condition", "train.adapter")]
    assert [s[0] for s in inner] == ["train.condition", "train.adapter"]
    assert all(_inside(s, top[1]) for s in inner)


def test_train_step_spans_in_order_and_the_loss_unchanged(tmp_path):
    plain = _trainer(tmp_path, "plain")
    plain.fit(_Loader(1), max_steps=1)
    traced = _trainer(tmp_path, "traced")
    _, sp = _profiled(lambda: traced.fit(_Loader(1), max_steps=1), tmp_path)
    _check_train_step(sp)
    assert traced.history[0]["loss"] == plain.history[0]["loss"]
    for (n, p), (_, q) in zip(plain.model.named_parameters(), traced.model.named_parameters()):
        assert torch.equal(p, q), n


def test_trainer_profile_window_records_the_train_spans(tmp_path):
    trainer = _trainer(tmp_path, profile_dir=str(tmp_path / "profile"), profile_start_step=1,
                       profile_num_steps=1)
    trainer.fit(_Loader(3), max_steps=3)
    sp = _trace_spans(tmp_path / "profile" / "trace_step1.json")
    _check_train_step(sp)  # step 2 alone


def test_log_window_reads_the_monotonic_clock(tmp_path, monkeypatch):
    ticks = iter(np.arange(0.0, 100.0, 0.5))
    clock = types.SimpleNamespace(perf_counter=lambda: float(next(ticks)))
    monkeypatch.setattr(trainer_mod, "time", clock)
    trainer = _trainer(tmp_path, log_every=2)
    trainer.fit(_Loader(5), max_steps=5)
    logged = [r for r in trainer.history if "steps_per_sec" in r]
    assert [r["step"] for r in logged] == [2, 4]
    for r in logged:
        assert r["seconds"] > 0
        assert r["imgs_per_sec_chip"] == pytest.approx(r["steps"] * B / r["seconds"], rel=1e-3)
