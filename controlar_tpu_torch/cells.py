"""The full-width configurations the port is run at on the card, with random
weights and inputs made from a seed. `chip_smoke.py` and `trace_decode` build
their pipelines here, so both drive the same configuration.

  c2i           GPT-B (12 layers, 12 heads, dim 768), 384 px = 576 tokens,
                CFG 4.0
  t2i           GPT-XL (36 layers, 20 heads, dim 1280), 512 px = 1024 tokens,
                CFG 7.5, 120-token random captions left-padded to CAPTION_LENS
  c2i_w8kv8     c2i with W8A16 weights (head included) and the int8 KV cache:
                the JAX package's CLI `--quant`
  c2i_3b_w4kv4  GPT-3B (24 layers, 32 heads x 100, dim 3200, FFN 8704), c2i
                384 px, CFG 4.0, W4A16 split-rope weights with fused w13, an
                int8 head and the int4 KV cache: the JAX package's
                `bench.py` extra_gpt3b_w4
  c2i_depth     c2i with depth control: the MiDaS DPT-Hybrid detector at its
                released width (`models/midas.MIDAS_HYBRID`, random weights
                from a seed) on the 384 px images, the depth control type
                both published ControlAR checkpoints (c2i, t2i) carry

All: batch 8 (16 rows with CFG), top_k 2000, Canny (but c2i_depth) on
synthetic images, DINOv2-small adapter, VQ-16 decoder, bf16 GPT (quantized
after it is made, layer by layer, on the device), fp32 adapter, decoder and
condition network.

The serving cells run `serve.ServeEngine` over the GPT of a pipeline cell,
with the traffic of the JAX package's `bench.py` extra_serve:

  serve_c2i         the c2i model, bf16 weights and cache
  serve_c2i_w8kv8   the c2i_w8kv8 model: W8A16 weights and the int8 cache
                    (the JAX CLI's `serve --quant`)

  serve_c2i_stacked the serve_c2i traffic with the stacked KV cache
                    (`ServeConfig(kv_stacked=True)`, the JAX package's
                    `scripts/bench_serve.py --stacked`)

max_slots 8 (16 rows with CFG), quantum 72, top_k 2000, CFG 4.0; 16
requests (`serve_requests`), 8 submitted up front and 8 after the second
`step()` (`serve_staggered`). Unlike extra_serve, each request carries the
adapter features of its own synthetic condition image.

The stacked-cache cells run `generate.generate(kv_stacked=True)` on a
pipeline cell's model, labels and adapter features (the pipeline's
`control_features` of the cell's Canny images), as the JAX package's
`scripts/bench_sweep.py --stacked` does, beside the same call with the
per-layer cache (`STACKED_CELLS`):

  c2i_stacked           the c2i cell
  c2i_w8kv8_stacked     the c2i_w8kv8 cell
  c2i_3b_w4kv4_stacked  the c2i_3b_w4kv4 cell

The speculative cells run `pipeline.generate(spec_draft="model")`: the JAX
CLI's `sample-c2i --gpt-model GPT-3B --spec-draft model --draft-gpt-model
GPT-B`, at the workload of the JAX package's `scripts/bench_spec.py` (c2i
384 px = 576 tokens, batch 8, CFG 4.0, top_k 2000, temperature 1.0, k = 4
drafts per cycle, Leviathan sampling). The draft is GPT-B (12 layers, 12
heads, dim 768), bf16, from another seed, on the target's cache dtype:

  spec_c2i_3b          target GPT-3B bf16, bf16 cache
  spec_c2i_3b_w8kv8    target GPT-3B W8A16 (head included), int8 cache
  spec_c2i_3b_w4kv4    target the c2i_3b_w4kv4 model, int4 cache

The training cells run `train.trainer.Trainer` on one fixed synthetic
batch (`train_batch`, as the JAX package's `scripts/bench_train.py` makes
it, with left-padded captions):

  train_t2i_xl512   the TrainerConfig defaults: GPT-XL t2i 512 px, DINOv2-small
                    adapter trained, Canny, batch 8, remat full
  train_t2i_b256    bench_train.py's default: GPT-B t2i 256 px, batch 16
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from controlar_tpu_torch.config import gpt_config, vq_config
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import midas as midas_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.pipeline import ControlARPipeline
from controlar_tpu_torch.quant import quantize_gpt
from controlar_tpu_torch.serve.engine import Request, ServeConfig, ServeEngine

_C2I = dict(model_type="c2i", cls_token_num=1, image_px=384, cfg_scale=4.0)
CELLS = {
    "c2i": dict(size="GPT-B", **_C2I),
    "t2i": dict(size="GPT-XL", model_type="t2i", cls_token_num=120, image_px=512,
                cfg_scale=7.5),
    "c2i_w8kv8": dict(size="GPT-B", **_C2I, quant="int8", cache_dtype=torch.int8),
    "c2i_3b_w4kv4": dict(size="GPT-3B", **_C2I, quant="w4", split_rope=True,
                         cache_dtype="int4"),
    "c2i_depth": dict(size="GPT-B", **_C2I, condition_type="depth"),
}
BATCH = 8
TOP_K = 2000
CAPTION_LENS = (17, 120, 64, 33, 90, 8, 51, 120)


def condition_images(n: int, size: int, seed: int) -> np.ndarray:
    """Blocky synthetic RGB images with real edges, uint8 (n, size, size, 3)."""
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 256, (n, size // 32, size // 32, 3)).astype(np.uint8)
    img = low.repeat(32, axis=1).repeat(32, axis=2)
    noise = rng.integers(-8, 9, img.shape)
    return np.clip(img.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def caption_mask(lens, width: int, device) -> torch.Tensor:
    """Left padding: (len(lens), width) int, 1 on the last lens[i] columns."""
    lens = torch.as_tensor(lens, device=device)
    return (torch.arange(width, device=device)[None, :] >= (width - lens)[:, None]).int()


# Captions for the text encoder: T5-XL (`models.t5.T5_XL`, flan-t5-xl's
# published widths) at its 120-token length, with token ids made from a seed
# (no tokenizer files ship with the repository).
CAPTION_TOKENS = 120
CAPTION_EOS = 1
_WORDS = ("a", "photo", "of", "red", "blue", "house", "tree", "river", "dog", "cat", "on",
          "the", "beach", "at", "night", "with", "mountains", "in", "fog", "street", "old",
          "city", "bright", "flowers", "small", "boat", "under", "clouds", "painting", "sky")


def caption_token_ids(n: int, seed: int, vocab_size: int = 32128,
                      length: int = CAPTION_TOKENS):
    """n tokenized captions as a T5 tokenizer lays them out: lengths drawn in
    [8, length], ids in [2, vocab) then EOS (1), right-padded with 0.
    -> (ids int64 (n, length), mask int64 (n, length))."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(8, length + 1, n)
    ids = rng.integers(2, vocab_size, (n, length))
    cols = np.arange(length)[None, :]
    ids = np.where(cols < lens[:, None] - 1, ids, 0)
    ids[np.arange(n), lens - 1] = CAPTION_EOS
    return ids, (cols < lens[:, None]).astype(np.int64)


def caption_texts(n: int, seed: int) -> List[str]:
    """n captions of 4 to 30 words drawn from a small vocabulary."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(_WORDS, rng.integers(4, 31))) for _ in range(n)]


def word_tokenizer(vocab_size: int = 32128):
    """A stand-in for flan-t5-xl's sentencepiece tokenizer with its layout:
    one id per whitespace word (2 + crc32 mod (vocab - 2)), truncated to
    max_length - 1, EOS, right padding. (texts, max_length) -> (ids, mask)."""
    import zlib

    def tokenize(texts: List[str], max_length: int):
        ids = np.zeros((len(texts), max_length), np.int64)
        for i, t in enumerate(texts):
            row = [2 + zlib.crc32(w.encode()) % (vocab_size - 2) for w in t.split()]
            row = row[:max_length - 1] + [CAPTION_EOS]
            ids[i, :len(row)] = row
        return ids, (ids != 0).astype(np.int64)

    return tokenize


def _gpt(cell: dict, size: str, seed: int, device):
    """-> (config, bf16 GPT of the cell's model type and image size)."""
    cfg = gpt_config(size, model_type=cell["model_type"], cls_token_num=cell["cls_token_num"],
                     block_size=(cell["image_px"] // 16) ** 2, vocab_size=16384,
                     num_classes=1000)
    return cfg, gpt_model.init_gpt(cfg, seed=seed, dtype=torch.bfloat16, device=device)


def build_cell(name: str, seed: int = 0, device="cuda", cells=CELLS, **pipe_kw):
    """-> (pipeline, keyword arguments of one `pipeline.generate` call).
    pipe_kw go to the pipeline (the speculative cells' draft)."""
    cell = cells[name]
    px = cell["image_px"]
    cfg, gpt = _gpt(cell, cell["size"], seed, device)
    vcfg = vq_config("VQ-16")
    if "quant" in cell:
        quantize_gpt(gpt, cfg, mode=cell["quant"], split_rope=cell.get("split_rope", False))
    if cell.get("condition_type") == "depth":
        pipe_kw = dict(pipe_kw, condition_type="depth", midas_cfg=midas_model.MIDAS_HYBRID,
                       midas=midas_model.init_midas(midas_model.MIDAS_HYBRID, seed=seed + 4,
                                                    device=device))
    pipe = ControlARPipeline(
        gpt_cfg=cfg,
        gpt=gpt,
        vq_cfg=vcfg, vq=vq_model.init_vq(vcfg, seed=seed + 1, device=device),
        adapter_cfg=vit_model.DINOV2_SMALL,
        adapter=vit_model.init_vit(vit_model.DINOV2_SMALL, seed=seed + 2, device=device),
        device=device, **pipe_kw)
    kw = dict(condition_images=condition_images(BATCH, px, seed + 7),
              cfg_scale=cell["cfg_scale"], top_k=TOP_K, cache_dtype=cell.get("cache_dtype"))
    if cell["model_type"] == "c2i":
        kw["labels"] = np.arange(BATCH) * 100
    else:
        gen = torch.Generator(device=device).manual_seed(seed + 3)
        masks = caption_mask(CAPTION_LENS, cfg.cls_token_num, device)
        caption = torch.randn(BATCH, cfg.cls_token_num, cfg.caption_dim, generator=gen,
                              device=device) * 0.1
        kw["caption_emb"] = caption.bfloat16() * masks[:, :, None]
        kw["emb_masks"] = masks
    return pipe, kw


SERVE_CELLS = {"serve_c2i": "c2i", "serve_c2i_w8kv8": "c2i_w8kv8",  # -> pipeline cell
               "serve_c2i_stacked": "c2i"}
SERVE_SLOTS, SERVE_QUANTUM = 8, 72
SERVE_REQUESTS, SERVE_UPFRONT, SERVE_ADD_AFTER_STEP = 16, 8, 2


def serve_requests(n: int, features=None, *, num_classes: int = 1000, cfg_scale: float = 4.0,
                   start_id: int = 0) -> List[Request]:
    """The serving traffic of the JAX package's extra_serve: request i has
    label (i * 37) % num_classes and seed i; with `features`, request i
    carries features[i] as its adapter features."""
    return [Request(request_id=start_id + i, label=(i * 37) % num_classes, cfg_scale=cfg_scale,
                    seed=i, adapter_features=None if features is None else features[i])
            for i in range(n)]


def serve_staggered(engine: ServeEngine, requests: List[Request], upfront: int,
                    add_after_step: int) -> List[Request]:
    """Submit the first `upfront` requests, the rest after step() number
    `add_after_step`, step until every request is done, collect what is in
    flight; returns the finished requests sorted by request_id."""
    for r in requests[:upfront]:
        engine.add_request(r)
    pending, steps = list(requests[upfront:]), 0
    while engine.has_unfinished() or pending:
        engine.step()
        steps += 1
        if steps >= add_after_step and pending:
            for r in pending:
                engine.add_request(r)
            pending = []
    engine.flush()
    done, engine.finished = engine.finished, []
    return sorted(done, key=lambda r: r.request_id)


def build_serve_cell(name: str, seed: int = 0, device="cuda"):
    """-> (pipeline of the cell's model, engine over its GPT (sync
    admission; the stacked cache for a `*_stacked` cell), adapter features
    (SERVE_REQUESTS, block_size, 384) of the cell's synthetic condition
    images, computed on the device)."""
    base = SERVE_CELLS[name]
    pipe, _ = build_cell(base, seed, device)
    scfg = ServeConfig(max_slots=SERVE_SLOTS, quantum=SERVE_QUANTUM, top_k=TOP_K,
                       cache_dtype=CELLS[base].get("cache_dtype") or torch.bfloat16,
                       kv_stacked=name.endswith("_stacked"))
    images = condition_images(SERVE_REQUESTS, CELLS[base]["image_px"], seed + 7)
    with torch.inference_mode():
        feats = pipe.control_features(pipe.extract_condition(images))
    return pipe, ServeEngine(pipe.gpt, pipe.gpt_cfg, scfg, device=device), feats


STACKED_CELLS = {"c2i_stacked": "c2i", "c2i_w8kv8_stacked": "c2i_w8kv8",  # -> pipeline cell
                 "c2i_3b_w4kv4_stacked": "c2i_3b_w4kv4"}


def build_stacked_cell(name: str, seed: int = 0, device="cuda"):
    """-> (pipeline of the cell's model, keyword arguments of one
    `generate.generate` call on it but `kv_stacked` and `seed`: labels,
    adapter features of the cell's condition images computed on the
    device, max_new_tokens, cfg_scale, top_k, cache_dtype, device)."""
    pipe, kw = build_cell(STACKED_CELLS[name], seed, device)
    with torch.inference_mode():
        feats = pipe.control_features(pipe.extract_condition(kw["condition_images"]))
    return pipe, dict(labels=kw["labels"], adapter_features=feats,
                      max_new_tokens=pipe.gpt_cfg.block_size, cfg_scale=kw["cfg_scale"],
                      top_k=kw["top_k"], cache_dtype=kw["cache_dtype"] or torch.bfloat16,
                      device=device)


SPEC_CELLS = {
    "spec_c2i_3b": dict(size="GPT-3B", **_C2I),
    "spec_c2i_3b_w8kv8": dict(size="GPT-3B", **_C2I, quant="int8", cache_dtype=torch.int8),
    "spec_c2i_3b_w4kv4": CELLS["c2i_3b_w4kv4"],
}
SPEC_DRAFT_SIZE = "GPT-B"
SPEC_K = 4  # drafts per cycle: the pipeline's k


def build_spec_cell(name: str, seed: int = 0, device="cuda"):
    """-> (pipeline with the GPT-B draft, keyword arguments of one
    speculative `pipeline.generate` call)."""
    cell = SPEC_CELLS[name]
    dcfg, draft = _gpt(cell, SPEC_DRAFT_SIZE, seed + 5, device)
    pipe, kw = build_cell(name, seed, device=device, cells=SPEC_CELLS, draft_gpt_cfg=dcfg,
                          draft_gpt=draft)
    return pipe, dict(kw, spec_draft="model")


# Training cells: `Trainer` (train/trainer.py) on one fixed synthetic batch.
TRAIN_CELLS = {
    # the TrainerConfig defaults: GPT-XL t2i 512 px (1024 tokens, T = 1143),
    # DINOv2-small adapter, Canny from raw images, remat full, fp32 moments,
    # dropout 0.1, class dropout 0.1; batch 8
    "train_t2i_xl512": dict(global_batch_size=8),
    # the JAX package's scripts/bench_train.py default: GPT-B t2i 256 px
    # (T = 375), batch 16, remat full
    "train_t2i_b256": dict(gpt_model="GPT-B", image_size=256, global_batch_size=16),
}


def train_caption_lens(n: int, seed: int) -> np.ndarray:
    """Valid caption lengths of a training batch, drawn in [16, 120]."""
    return np.random.default_rng(seed + 11).integers(16, 121, n)


def train_batch(cfg, batch: int, image_px: int, seed: int) -> dict:
    """One synthetic host batch as `scripts/bench_train.py` makes it (random
    tokens, captions and raw RGB images, valid ones), with the captions
    left-padded to lengths drawn in [16, 120] so that the caption bias runs."""
    rng = np.random.default_rng(seed)
    lens = train_caption_lens(batch, seed)
    return {
        "tokens": rng.integers(0, cfg.vocab_size, (batch, cfg.block_size)).astype(np.int32),
        "caption_emb": rng.standard_normal((batch, cfg.cls_token_num, cfg.caption_dim)
                                           ).astype(np.float32),
        "emb_mask": (np.arange(cfg.cls_token_num)[None, :]
                     >= (cfg.cls_token_num - lens)[:, None]).astype(np.int32),
        "control_image": rng.integers(0, 255, (batch, image_px, image_px, 3)).astype(np.uint8),
        "valid": np.ones((batch,), np.float32),
    }


class FixedBatchLoader:
    """A loader (set_epoch, iteration) that yields one host batch `steps`
    times an epoch."""

    def __init__(self, batch: dict, steps: int = 1):
        self.batch, self.steps = batch, steps

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        return iter([self.batch] * self.steps)


def build_train_cell(name: str, seed: int = 0, device="cuda", results_dir=None, **overrides):
    """-> (Trainer of the cell, its fixed host batch). overrides go to the
    TrainerConfig (e.g. log_every, profile_dir)."""
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    tcfg = TrainerConfig(**TRAIN_CELLS[name], seed=seed,
                         results_dir=results_dir or f"results/{name}", **overrides)
    trainer = Trainer(tcfg, device=device)
    return trainer, train_batch(trainer.gpt_cfg, tcfg.global_batch_size, tcfg.image_size,
                                seed + 7)
