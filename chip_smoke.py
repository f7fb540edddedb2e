#!/usr/bin/env python3
"""Drive the PyTorch port (controlar_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line and each
ending the run with a non-zero exit when it fails:

  device        the card's name and power limit (nvidia-smi), the kernel build;
  kernel        every CUDA kernel against its plain PyTorch version at the main
  kernel_q8     paths' shapes, with its time, the plain version's, one PyTorch
  kernel_q4     library call's and the bound: bf16, int8 and int4 decode
  kernel_w4mm   attention, the W4 dequant-matmul and the fused W4 FFN (timed
  kernel_w4ffn  at 16 rows, decode, and 64, the speculative verify; a row's
                result the same bit for bit in a 16- and a 64-row call);
  kernel_q8_append  the int8 decode attention with the in-flight row
                appended (a TPU kernel on no path of the JAX package: only
                this phase launches it), slabs bit for bit, timed at the
                c2i_w8kv8 last step;
  kernel_append the fused KV write (append_kv) of a decode step, bit for
                bit against its plain version and against the old write
                sequence (cat, quantizer, one append per stream) on bf16,
                int8 and int4 caches, timed against both; then the
                single-stream row append (on no path), bit for bit;
  kernel_chunk  the speculative verify's K-query chunk attention, bf16,
  kernel_chunk_q8  int8 and int4 (split and interleaved), against its plain
  kernel_chunk_q4  version at the spec cells' verify (K = 4, GPT-3B heads),
                with K = 1 and 8, the t2i caption bias (diagonal exception)
                and a 120-query prefill chunk; timed with the plain version,
                SDPA over the live rows and the bound;
  kernel_append_block  the same for a verify chunk (T = 4 and 8), then the
                single-stream K-row block append (on no path), bit for bit;
  kernel_stacked     decode attention over one layer of the stacked cache
  kernel_stacked_q8  plus the in-flight row, bf16, int8 and int4 (split at
  kernel_stacked_q4  GPT-3B, interleaved at GPT-B), against its plain version
                at the stacked cells' last steps, the t2i caption bias and
                per-slot positions, first and last layer; timed with the
                plain version, SDPA over the layer's slab with the row
                written and the bound;
  kernel_append_stacked  the stacked cache's end-of-step write (every
                layer's in-flight rows of every stream in one launch) against
                its plain version and the step's writes against the old
                sequence, bit for bit, at int and per-slot positions; then
                the single-stream stacked append (on no path), bit for bit;
  kernel_train_fwd  the training attention's forward, dq and dk/dv kernels
  kernel_train_dq   against their plain versions at the training cells'
  kernel_train_dkv  shapes (caption bias), c2i without bias and D = 100;
                timed with the plain version, SDPA (boolean mask; forward,
                and the autograd backward; is_causal=True at the case
                without a bias) and the bound, the forward with its
                variant and host us a call;
  reference     small models on the card against the same models on the CPU
                (the CPU path is the one the tests hold to the JAX package):
                bf16, W8 + int8 cache, W4 split-rope + int4 cache, each with
                the per-layer and with the stacked cache;
  serve_reference  the same three small models through per-slot decode steps
                (decode_step_multi), card against CPU, with either cache, and
                a small serving engine's slot isolation on the card, with
                either cache;
  spec_reference  the three small models through verify chunks
                (forward_chunk), card against CPU, and greedy speculative
                decode against greedy decode on the card;
  train_reference  small t2i and c2i control models: loss and gradients
                under the six remat policies on the card (equal, forward
                launches exact), then control train steps card against CPU;
                then c2i steps on a frozen small HED and lineart, card
                against CPU;
  condition_reference  small HED, lineart, DPT and MiDaS through the
                pipeline's condition maps, card against CPU (fp32), and
                hed_nms bit for bit;
  condition     the condition networks at full width (HED, lineart at the
                annotators' widths, DPT-Large, MiDaS DPT-Hybrid), batch 8 at
                512 px: ms of a call and peak memory;
  checkpoint    GPT-B c2i, the VQ-16 with its encoder and DINOv2-small from
                seeds, written in the reference layouts ({"model": sd,
                "args": Namespace} .pt, .safetensors in fp32 and bf16) and
                read back through the port's loaders onto the card, bit for
                bit; the VQ's encode and decode_code card against CPU; a
                pipeline of the loaded modules greedy token for token
                against one built from the seeds; ms and GB per file;
  quality       GPT-B c2i toy-trained on the card (basic task, 150 AdamW
                steps, the training kernels), loss under 2.0; the quant
                report on the trained bf16 model in five modes (int8 and
                int8+kv8 gated at teacher-forced agreement 0.99), each
                mode's kernels launched; greedy speculative decode with an
                int8 self-draft, above 2 accepted tokens a cycle;
  c2i           GPT-B class-to-image at 384 px through ControlARPipeline:
                Canny -> DINOv2-small -> CFG decode -> VQ-16, batch 8;
  c2i_depth     the c2i cell with depth control: the MiDaS DPT-Hybrid
                detector at full width on the 384 px images, stage seconds;
  t2i           GPT-XL text-to-image at 512 px with left-padded captions (12
                of its 36 layers);
  c2i_w8kv8     c2i with W8A16 weights and the int8 KV cache;
  c2i_3b_w4kv4  GPT-3B c2i with W4A16 split-rope weights and the int4 cache;
  c2i_stacked   generate.generate on the c2i, c2i_w8kv8 and c2i_3b_w4kv4
  c2i_w8kv8_stacked  models with the per-layer and with the stacked cache
  c2i_3b_w4kv4_stacked  (kv_stacked=True): kernels per step of each, their
                first decode steps from one prefill, then a timed call
                of each, flat then stacked (the GPT-3B at 8 of 24 layers);
  serve_c2i     continuous-batching serving (ServeEngine) of the c2i model,
                16 requests with adapter features on 8 slots, quantum 72,
                timed sync, overlapped, overlapped, sync (identical
                tokens and statistics required), then VQ-16 decoded;
  serve_c2i_w8kv8  the same traffic on the c2i_w8kv8 model and int8 cache;
  serve_c2i_stacked  the serve_c2i traffic with ServeConfig(kv_stacked=True),
                timed sync then overlapped (identical tokens required);
  spec_c2i_3b   speculative decode through ControlARPipeline.generate(
                spec_draft="model"): GPT-3B c2i at 384 px drafted by GPT-B,
                k = 4, batch 8, CFG 4.0, top_k 2000, Leviathan sampling (the
                target at 8 of 24 layers, the draft at 4 of 12);
  spec_c2i_3b_w8kv8  the same with a W8A16 target and the int8 cache;
  spec_c2i_3b_w4kv4  the same with the c2i_3b_w4kv4 target and int4 cache;
  train_t2i_b256  control fine-tuning through Trainer.fit: GPT-B t2i 256 px,
                DINOv2-small trained, Canny, batch 16, remat full;
  train_t2i_xl512  the TrainerConfig defaults: GPT-XL t2i 512 px, batch 8;
  captions      the text encoder at T5-XL's published widths (random weights
                from a seed) on 8 seed-made token-id captions: card vs CPU
                at 2 layers (fp32), bf16 vs fp32 at 2 and 24 layers, ms,
                TFLOP/s and peak memory of a bf16 encode; its features then
                drive one t2i generate call (GPT-XL 512 px), launches exact;
  extract_train  16 synthetic 512 px images with captions through
                extract_tree (VQ-16 encoder, T5-XL) into a tree, codes equal
                a direct encode, pack_tree and pack_control_dataset into
                .car files, tree and .car batches identical and valid, a c2i
                extract (flip, Canny, 256 px) into C2ICodeDataset, then the
                .car through ShardedLoader into 3 Trainer.fit steps at
                train_t2i_xl512's config, B10 launches exact;
  train_vq      tokenizer training at VQ-16's published widths (LPIPS at
                VGG16's, PatchGAN ndf 64; fp32, TF32 off): the generator's and
                discriminator's losses, adaptive weight and gradients card vs
                CPU at 64 px; 256 px batch 16 steps timed with PatchGAN and
                with StyleGAN; 30 reconstruction-only steps, the loss falling;
                the checkpoint's EMA through load_vq_checkpoint into
                reconstruction_eval (PSNR, MS-SSIM, PNG pairs, samples.npz);
  multiscale    arbitrary-resolution control training: a small model's loss
                and gradients card vs CPU at 64 x 64 and 64 x 96, then GPT-XL
                t2i (HED, DINOv2-small, VQ-16 encoder, batch 8) at 512 x 512,
                384 x 768 and 1024 x 576 (T up to 2423): ms a step, peak
                memory, B10 launches exact, the codes a direct encode's;
  adafactor     toy_train at GPT-3B, block 576, batch 16, with Adafactor for 10
                steps: ms a step, peak memory, B10 launches exact (D 100);
  eval_reference  the evaluation's parts card against CPU (fp32, TF32 off):
                the FID InceptionV3 at full width on 4 images (pool3,
                spatial, logits), the precision / recall radii and
                memberships from the card's distance matmuls against
                float64 numpy on 256 features of 2048, a narrow DeepLabV3,
                a narrow taming VQGAN (codes equal);
  eval_fid      generate then score, the slice's main path: the c2i cell's
                pipeline through sample_c2i_fid for 16 images (two calls,
                B1 and append_kv launches exact) into samples.npz, then
                evaluate_all (bf16 InceptionV3, seed weights) against 32
                seed reference images: FID, sFID, IS, precision, recall
                finite; seconds of each, Inception images/s at batch 64 in
                bf16 and fp32, peak memory;
  eval_models   DeepLabV3-R101 (171 classes) written as an mmseg .pth and
                loaded by load_mmseg_segmenter segments 8 of the samples
                (512 px after its resize) into cocostuff_miou; the
                vqgan_imagenet_f16_16384 taming VQGAN through
                checkpoint.load_taming reconstructs 8 images at 256 px: ms,
                PSNR, peak memory (seed weights, fp32);
then the `kernels` line and, last, the `ok` line. The cells are built by
`controlar_tpu_torch.cells`; weights are random, made from fixed seeds. The
t2i cell (and the captions phase's t2i call) runs GPT-XL at 12 of its 36
layers, c2i_3b_w4kv4_stacked GPT-3B at 8 of 24, the speculative cells a
GPT-3B target at 8 of 24 layers drafted by GPT-B at 4 of 12 (`CELL_DEPTH`,
`SPEC_DEPTH`: the smoke's time; widths and per-layer launches as at full
depth). Each JSON line carries `elapsed_s`, the seconds since the start. The
generation cells run a 16-step warm call and one timed call, the
stacked cells one timed call with each cache, the
speculative cells a 16-token warm call and one timed call, the training
cells two warm and five timed steps on one fixed batch. Each cell phase sets every
kernel's launch count to 0 before its timed calls (a speculative cell before
each call) and checks each count after them. TF32 is off throughout, so
fp32 matmuls and convolutions run in full fp32 and the reference
comparisons are fp32 against fp32.
Exits non-zero, printing no result, when there is no CUDA device.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12         # H100 SXM bf16 tensor cores, dense
# kernel vs plain version: |out - ref| <= ATOL + RTOL * |ref|. Both round the
# output to bf16, whose step is 2**-7 relative: RTOL covers one step at any
# size, ATOL one step below 0.5. At the deepest decode step |out| ~ 0.02, so a
# dropped block of rows or a misapplied bias (~1e-2) fails.
KERNEL_ATOL, KERNEL_RTOL = 2e-3, 1e-2
REF_TOL = 1e-3              # fp32 model on card vs CPU; bf16 cache identical
# W4 limits: bf16 outputs (step 2**-7 relative) over fp32 sums in another
# order; |out| ~ 1 at these weights, and a dropped plane moves it by ~0.1.
W4_ATOL, W4_RTOL = 1e-2, 1e-2


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and the seconds since the script
    started (`elapsed_s`)."""
    print(json.dumps({"phase": phase, **fields,
                      "elapsed_s": time.perf_counter() - T_START}), flush=True)


def check(ok: bool, phase: str, msg: str) -> None:
    if not ok:
        emit(phase, ok=False, error=msg)
        sys.exit(1)


def time_ms(fn, reps: int = 20, flush: torch.Tensor | None = None) -> float:
    """Median device time of fn over reps launches, CUDA events around each.
    A device-side sleep first lets the host queue every launch ahead, so
    host overhead does not enter the times; `flush` is overwritten before
    each launch so that the 50 MB L2 holds none of fn's inputs."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(reps)]
    torch.cuda._sleep(50_000_000)
    for start, end in ev:
        if flush is not None:
            flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def host_us(fn, reps: int = 50, rounds: int = 20) -> float:
    """Least over rounds of the host microseconds a call of fn takes to
    return: a device-side sleep first keeps every launch queued behind it,
    so no call waits for the device. The least, since what else runs on a
    shared host only adds to a round (medians of one tree's rows spread
    2x)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        torch.cuda._sleep(30_000_000)  # ~15 ms, past the round's calls
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) / reps * 1e6)
        torch.cuda.synchronize()
    return min(times)


def _kernels():
    """name -> (wrapper, CUDA source, the TPU kernel it replaces)."""
    from controlar_tpu_torch.ops import cache_append as ca
    from controlar_tpu_torch.ops import flash_chunk as fc
    from controlar_tpu_torch.ops import flash_decode as fd
    from controlar_tpu_torch.ops import flash_decode_stacked as fds
    from controlar_tpu_torch.ops import flash_train as ft
    from controlar_tpu_torch.ops import w4_matmul as w4

    return {
        "flash_decode_attention": (fd.flash_decode_attention, "flash_decode.cu",
                                   "controlar_tpu/ops/flash_decode2.py:24"),
        "flash_decode_attention_q8": (fd.flash_decode_attention_q8, "flash_decode_q8.cu",
                                      "controlar_tpu/ops/flash_decode2.py:177"),
        "flash_decode_attention_q4": (fd.flash_decode_attention_q4, "flash_decode_q4.cu",
                                      "controlar_tpu/ops/flash_decode2.py:592"),
        "w4_matmul": (w4.w4_matmul, "w4_matmul.cu", "controlar_tpu/ops/w4_matmul.py:160"),
        "w4_ffn": (w4.w4_ffn, "w4_ffn.cu", "controlar_tpu/ops/w4_matmul.py:242"),
        "append_kv": (ca.append_kv, "cache_append.cu", "controlar_tpu/ops/cache_append.py:32"),
        "cache_append_rows": (ca.cache_append_rows, "cache_append.cu",
                              "controlar_tpu/ops/cache_append.py:32"),
        "flash_chunk_attention": (fc.flash_chunk_attention, "flash_chunk.cu",
                                  "controlar_tpu/ops/flash_chunk.py:27"),
        "flash_chunk_attention_q8": (fc.flash_chunk_attention_q8, "flash_chunk.cu",
                                     "controlar_tpu/ops/flash_chunk.py:27"),
        "flash_chunk_attention_q4": (fc.flash_chunk_attention_q4, "flash_chunk_q4.cu",
                                     "controlar_tpu/ops/flash_chunk.py:260"),
        "cache_append_block": (ca.cache_append_block, "cache_append.cu",
                               "controlar_tpu/ops/cache_append.py:90"),
        "flash_train_fwd": (ft.flash_train_fwd, "flash_train.cu",
                            "controlar_tpu/ops/flash_train_pallas.py:54"),
        "flash_train_dq": (ft.flash_train_dq, "flash_train.cu",
                           "controlar_tpu/ops/flash_train_pallas.py:123"),
        "flash_train_dkv": (ft.flash_train_dkv, "flash_train.cu",
                            "controlar_tpu/ops/flash_train_pallas.py:155"),
        "flash_stacked": (fds.flash_stacked, "flash_decode.cu",
                          "controlar_tpu/ops/flash_decode_stacked.py:84"),
        "flash_stacked_q8": (fds.flash_stacked_q8, "flash_decode_q8.cu",
                             "controlar_tpu/ops/flash_decode_stacked.py:225"),
        "flash_stacked_q4": (fds.flash_stacked_q4, "flash_decode_q4.cu",
                             "controlar_tpu/ops/flash_decode_stacked.py:391"),
        "append_stacked": (ca.append_stacked, "cache_append.cu",
                           "controlar_tpu/ops/cache_append.py:159"),
        "cache_append_rows_stacked": (ca.cache_append_rows_stacked, "cache_append.cu",
                                      "controlar_tpu/ops/cache_append.py:159"),
        "flash_decode_attention_q8_append": (fd.flash_decode_attention_q8_append,
                                             "flash_decode_q8.cu",
                                             "controlar_tpu/ops/flash_decode2.py:349"),
    }


# kernels that no path launches, with the reason: their entries count the
# launches of their kernel phase instead of a main path's
OFF_PATH = {
    "flash_decode_attention_q8_append": (
        "no path of the JAX package runs flash_decode_attention2_q8_append (only "
        "tests/test_kv_int8.py calls it), so the port's int8 decode step keeps the "
        "separate row append and attention, as the JAX package's does"),
    "cache_append_rows": (
        "the decode steps write a layer's rows with append_kv, one launch that quantizes "
        "them and writes every stream; the single-stream append stays as the counterpart "
        "of the JAX package's cache_append_rows API"),
    "cache_append_block": (
        "the verify chunk writes a layer's rows with append_kv, one launch that quantizes "
        "them and writes every stream; the single-stream block append stays as the "
        "counterpart of the JAX package's cache_append_block API"),
    "cache_append_rows_stacked": (
        "the stacked decode step writes a layer's rows into the step's in-flight rows with "
        "append_kv and every stream into the stacked cache with one append_stacked; the "
        "single-stream stacked append stays as the counterpart of the JAX package's "
        "cache_append_rows_stacked API"),
}
# the TPU kernels a kernel replaces besides its `replaces`: the fused write is
# the decode steps' row append (B6) and the verify's block append (B9)
ALSO_REPLACES = {"append_kv": ["controlar_tpu/ops/cache_append.py:90"]}


def _roofline(nbytes: float, flops: float, flop_rate: float):
    """Least time (ms) for the work: bytes over the HBM rate or operations
    over the peak rate of their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _within(out, ref, atol, rtol):
    """-> (max abs error, whether every element is finite and within
    |out - ref| <= atol + rtol * |ref|)."""
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= atol + rtol * ref.float().abs()).all()) and bool(torch.isfinite(out).all())
    return err.max().item(), ok


def phase_device():
    from controlar_tpu_torch import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    built = time.perf_counter() - t0
    ptxas = [ln.strip() for src in _build.sources() for ln in _build.build_log(src.stem).splitlines()
             if "registers" in ln or "spill" in ln]
    emit("device", ok=True, nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
         build_s=built, ptxas=ptxas)


def _slab(gen, b, s, h, d):
    q = (torch.randn(b, h * d, generator=gen, device="cuda") * 0.5).bfloat16()
    kv = (torch.randn(b, s, 2 * h * d, generator=gen, device="cuda") * 0.5).bfloat16()
    return q, kv


def _kernel_error(out, ref):
    """-> (max abs error, whether every element is within the attention
    kernels' limit)."""
    return _within(out, ref, KERNEL_ATOL, KERNEL_RTOL)


def _left_pad_bias(s, t_cls):
    """(16, s) additive caption bias: the cells' caption lengths, left-padded
    in the first t_cls columns, for both CFG halves."""
    from controlar_tpu_torch.cells import CAPTION_LENS, caption_mask

    keep = caption_mask(CAPTION_LENS * 2, t_cls, "cuda").bool()
    keep = torch.cat([keep, torch.ones(16, s - t_cls, dtype=torch.bool, device="cuda")], 1)
    return torch.where(keep, 0.0, -1e9).float()


def _bound(b_rows, h, d, with_bias):
    """Least time for one call: bytes moved over HBM rate vs fp32 flops over
    the fp32 rate. b_rows: live rows per batch row (pos + 1)."""
    rows = sum(b_rows)
    nbytes = 2 * len(b_rows) * h * d * 2 + rows * 2 * h * d * 2 + (rows * 4 if with_bias else 0)
    return _roofline(nbytes, 4 * rows * h * d, FP32_FLOPS)


def phase_kernel():
    """flash_decode_attention at the main path's shapes: 16 rows (batch 8
    with CFG); c2i GPT-B (12 x 64 heads, 768 cache rows = 577 rounded up to
    256, pos 0..575), t2i GPT-XL (20 x 64 heads, 1280 rows = 1144 rounded
    up, pos 119..1142, caption bias), and head dims 100 and 128 (GPT-3B,
    GPT-7B), at `_positions`' (the kernel's 64-row chunk boundaries at D =
    64) and, at D = 100 and 128, both sides of the first boundary of their
    32- and 128-row chunks, with and without the left-padded bias. Timed at
    each case's last decode step with and
    without the bias, and c2i also at pos 255, mid-decode; the c2i and t2i
    rows also give the wrapper's host time."""
    import torch.nn.functional as F

    from controlar_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b = 16
    cases = [  # name, heads, head_dim, cache rows, caption columns, positions, timed positions
        ("c2i", 12, 64, 768, 120, _positions("c2i"), (575, 255)),
        ("t2i", 20, 64, 1280, 120, _positions("t2i"), (1142,)),
        # the live rows (pos + 1) on each side of the 32- and 128-row chunk boundaries
        ("d100", 32, 100, 768, 120, (30, 31, 32) + _positions("c2i"), (575,)),
        ("d128", 32, 128, 768, 120, (126, 127, 128) + _positions("c2i"), (575,)),
    ]
    results, max_err, main = [], 0.0, {}
    for name, h, d, s, t_cls, positions, timed_at in cases:
        q, kv = _slab(gen, b, s, h, d)
        bias = _left_pad_bias(s, t_cls)
        for pos in positions:
            for col_bias in (None, bias):
                out = flash_decode_attention(q, kv, pos, col_bias, n_head=h)
                torch.cuda.synchronize()
                ref = flash_decode_attention_ref(q, kv, pos, col_bias, n_head=h)
                err, ok = _kernel_error(out, ref)
                where = pos if isinstance(pos, int) else "per_slot"
                check(ok, "kernel", f"{name} h={h} d={d} pos={where} "
                      f"bias={col_bias is not None}: max_abs_err {err} over the limit")
                max_err = max(max_err, err)
        for timed in timed_at:
            for col_bias in (None, bias) if timed == timed_at[0] else (None,):
                fn = lambda: flash_decode_attention(q, kv, timed, col_bias, n_head=h)  # noqa: E731
                ms = time_ms(fn, flush=flush)
                plain = time_ms(lambda: flash_decode_attention_ref(q, kv, timed, col_bias,
                                                                   n_head=h), flush=flush)
                # library yardstick: SDPA over the live rows (never called by the port)
                hd, n = h * d, timed + 1
                q4 = q.view(b, h, 1, d)
                k4 = kv[:, :n, :hd].view(b, n, h, d).transpose(1, 2)
                v4 = kv[:, :n, hd:].view(b, n, h, d).transpose(1, 2)
                mask = None if col_bias is None else col_bias[:, None, None, :n].bfloat16()
                lib = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask),
                              flush=flush)
                bound, by = _bound([n] * b, h, d, col_bias is not None)
                row = dict(case=name, h=h, d=d, s=s, pos=timed, bias=col_bias is not None, ms=ms,
                           plain_ms=plain, library_ms=lib, bound_ms=bound, bound_by=by)
                if name in ("c2i", "t2i"):
                    row["host_us"] = host_us(fn)
                results.append(row)
                # the rows each cell's main path runs at its last step
                if timed == timed_at[0] and (name, col_bias is None) in (("c2i", True),
                                                                          ("t2i", False)):
                    main[name] = row
    emit("kernel", ok=True, name="flash_decode_attention", max_abs_err=max_err,
         atol=KERNEL_ATOL, rtol=KERNEL_RTOL, timings=results)
    return main, max_err


def _positions(h_case):
    """The decode positions each attention case is checked at, per-slot
    vectors included (16 rows: batch 8 with CFG). 62-64 and 126-128 put the
    live rows (pos + 1) on each side of a boundary of the split bf16 and
    int8 kernels' 64-row chunks at D = 64."""
    def slots(*p):
        return torch.tensor(p, dtype=torch.int32, device="cuda")

    c2i = (0, 1, 62, 63, 64, 255, 256, 575,
           slots(0, 1, 62, 63, 64, 255, 256, 300, 400, 500, 575, 575, 10, 20, 50, 767))
    t2i = (119, 120, 127, 128, 631, 1142, slots(119, 120, 126, 127, 128, 631, 700, 800, 900,
                                                1000, 1100, 1142, 1142, 130, 1279, 500))
    return t2i if h_case == "t2i" else c2i


def _q4_positions(d):
    """The int4 kernels' checks at head dim d: `_positions("c2i")` and the
    live rows (pos + 1) on each side of the first two boundaries of their
    chunks of CHUNK_ROWS[INT4][d] rows, alone and in a per-slot vector."""
    from controlar_tpu_torch.ops.flash_decode import CHUNK_ROWS, INT4

    c = CHUNK_ROWS[INT4][d]
    edges = (c - 2, c - 1, c, 2 * c - 2, 2 * c - 1, 2 * c)
    slots = torch.tensor(edges + (1, 255, 256, 300, 400, 500, 575, 575, 10, 767),
                         dtype=torch.int32, device="cuda")
    return edges + _positions("c2i") + (slots,)


def _attn_row(name, fn, plain, lib, h, d, s, pos, with_bias, slab_bytes_per_row, flush):
    """Time one attention call (kernel, plain version, library yardstick)
    and its bound: q and out bf16, the live rows' values and f32 scales,
    the bias row; 4 fp32 flops per value pair. host_us: the wrapper's host
    time a call."""
    b, n = 16, pos + 1
    nbytes = 2 * b * h * d * 2 + b * n * (slab_bytes_per_row + 2 * h * 4 + 4 * with_bias)
    bound, by = _roofline(nbytes, 4 * b * n * h * d, FP32_FLOPS)
    return dict(case=name, h=h, d=d, s=s, pos=pos, bias=with_bias,
                ms=time_ms(fn, flush=flush), plain_ms=time_ms(plain, flush=flush),
                library_ms=time_ms(lib, flush=flush), bound_ms=bound, bound_by=by,
                host_us=host_us(fn))


def _sdpa(q, slab, n, h, d, bias):
    """The library yardstick: SDPA over the first n rows of a dequantized
    bf16 [k|v] slab (never called by the port)."""
    import torch.nn.functional as F

    b, hd = q.shape[0], h * d
    k4 = slab[:, :n, :hd].reshape(b, n, h, d).transpose(1, 2)
    v4 = slab[:, :n, hd:].reshape(b, n, h, d).transpose(1, 2)
    mask = None if bias is None else bias[:, None, None, :n].bfloat16()
    q4 = q.view(b, h, 1, d)
    return lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)


def phase_kernel_q8():
    """flash_decode_attention_q8 at the int8 paths' shapes: c2i GPT-B (12 x
    64 heads, 768 rows, the c2i_w8kv8 cell) and t2i GPT-XL (20 x 64, 1280
    rows, caption bias), each position with and without the bias; the last
    decode step of each is timed, the c2i one without bias (its main path),
    and c2i also at pos 255, mid-decode."""
    from controlar_tpu_torch.ops.flash_decode import (
        flash_decode_attention_q8 as kern,
        flash_decode_attention_q8_ref as plain,
    )
    from controlar_tpu_torch.quant import dequantize_kv_slab, quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results, max_err, main = [], 0.0, None
    for name, h, d, s, timed_at, timed_bias in (("c2i", 12, 64, 768, (575, 255), False),
                                                ("t2i", 20, 64, 1280, (1142,), True)):
        q, kv = _slab(gen, 16, s, h, d)
        rows, scale = quantize_kv_rows(kv, h)
        bias = _left_pad_bias(s, 120)
        for pos in _positions(name):
            for col_bias in (None, bias):
                out = kern(q, rows, scale, pos, col_bias, n_head=h)
                torch.cuda.synchronize()
                err, ok = _kernel_error(out, plain(q, rows, scale, pos, col_bias, n_head=h))
                where = pos if isinstance(pos, int) else "per_slot"
                check(ok, "kernel_q8", f"{name} pos={where} bias={col_bias is not None}: "
                      f"max_abs_err {err} over the limit")
                max_err = max(max_err, err)
        cb = bias if timed_bias else None
        slab = dequantize_kv_slab(rows, scale, h, torch.bfloat16)
        for timed in timed_at:
            row = _attn_row(name, lambda: kern(q, rows, scale, timed, cb, n_head=h),
                            lambda: plain(q, rows, scale, timed, cb, n_head=h),
                            _sdpa(q, slab, timed + 1, h, d, cb), h, d, s, timed, timed_bias,
                            2 * h * d, flush)
            results.append(row)
            main = main or row
    emit("kernel_q8", ok=True, name="flash_decode_attention_q8", max_abs_err=max_err,
         atol=KERNEL_ATOL, rtol=KERNEL_RTOL, timings=results)
    return main, max_err


def phase_kernel_q4():
    """flash_decode_attention_q4 at GPT-3B (32 x 100 heads, 768 rows, the
    c2i_3b_w4kv4 cell's split layout) and at 12 x 64 (the w4kv4 spec
    draft's GPT-B, interleaved), split and interleaved, at `_q4_positions`
    (the boundaries of the kernel's chunks) with and without a bias; timed
    without bias at the last decode step (pos 575) and at pos 255, each row
    with the wrapper's host time."""
    from controlar_tpu_torch.ops.flash_decode import (
        flash_decode_attention_q4 as kern,
        flash_decode_attention_q4_ref as plain,
    )
    from controlar_tpu_torch.quant import dequantize_kv4_slab, quantize_kv_rows_4

    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results, max_err, main = [], 0.0, None
    for name, h, d in (("3b", 32, 100), ("b", 12, 64)):
        q, kv = _slab(gen, 16, 768, h, d)
        bias = _left_pad_bias(768, 120)
        for split in (True, False):
            rows, scale = quantize_kv_rows_4(kv, h, split=split)
            kw = dict(n_head=h, head_dim=d, split=split)
            for pos in _q4_positions(d):
                for col_bias in (None, bias):
                    out = kern(q, rows, scale, pos, col_bias, **kw)
                    torch.cuda.synchronize()
                    err, ok = _kernel_error(out, plain(q, rows, scale, pos, col_bias, **kw))
                    where = pos if isinstance(pos, int) else "per_slot"
                    check(ok, "kernel_q4", f"{name} split={split} pos={where} bias="
                          f"{col_bias is not None}: max_abs_err {err} over the limit")
                    max_err = max(max_err, err)
            slab = dequantize_kv4_slab(rows, scale, h, d, torch.bfloat16, split=split)
            for timed in (575, 255):
                row = _attn_row(f"{name}_{'split' if split else 'interleaved'}",
                                lambda: kern(q, rows, scale, timed, None, **kw),
                                lambda: plain(q, rows, scale, timed, None, **kw),
                                _sdpa(q, slab, timed + 1, h, d, None), h, d, 768, timed, False,
                                h * d, flush)
                results.append(row)
                main = main or row
    emit("kernel_q4", ok=True, name="flash_decode_attention_q4", max_abs_err=max_err,
         atol=KERNEL_ATOL, rtol=KERNEL_RTOL, timings=results)
    return main, max_err


def _w4_weight(gen, k, n):
    from controlar_tpu_torch.ops.w4_matmul import quantize_weight_w4

    return quantize_weight_w4(torch.randn(k, n, generator=gen, device="cuda") * 0.02)


def _w4_row(case, rows, fn, plain, lib, nbytes, flops, flush, **shape):
    bound, by = _roofline(nbytes, flops, BF16_FLOPS)
    return dict(case=case, rows=rows, **shape, ms=time_ms(fn, flush=flush),
                plain_ms=time_ms(plain, flush=flush), library_ms=time_ms(lib, flush=flush),
                bound_ms=bound, bound_by=by, host_us=host_us(fn))


def _batch_invariant(phase, name, fn, x):
    """A row's result does not depend on the rows beside it: rows of a
    64-row call equal the same rows in a 16-row call and alone, bit for bit
    (greedy speculative decode, whose verify runs 64 rows, relies on it)."""
    full = fn(x)
    torch.cuda.synchronize()
    same = torch.equal(fn(x[16:32].contiguous()), full[16:32]) and all(
        torch.equal(fn(x[i:i + 1].contiguous()), full[i:i + 1]) for i in (0, 17, 63))
    check(same, phase, f"{name}: a row of the 64-row call differs from the same row in a "
          "smaller call")


W4_TIMED_ROWS = (16, 64)  # decode with CFG, the speculative verify (16 x (k = 4))


def phase_kernel_w4mm():
    """w4_matmul at GPT-3B wqkv (3200 -> 9600) and wo (3200 -> 3200), with
    weights of the model's init scale (std 0.02), 1, 16, 17, 64 and 256 rows
    of bf16 activations; batch invariance at 64 rows; timed at 16 rows (the
    main path's batch with CFG) and 64 (the speculative verify)."""
    from controlar_tpu_torch.ops.w4_matmul import (
        dequantize_weight_w4,
        w4_matmul as kern,
        w4_matmul_ref as plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(3)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    results, max_err = [], 0.0
    for name, k, n in (("wqkv", 3200, 9600), ("wo", 3200, 3200)):
        q4, s = _w4_weight(gen, k, n)
        for rows in (1, 16, 17, 64, 256):
            x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()
            out = kern(x, q4, s)
            torch.cuda.synchronize()
            err, ok = _within(out, plain(x, q4, s), W4_ATOL, W4_RTOL)
            check(ok, "kernel_w4mm", f"{name} rows={rows}: max_abs_err {err} over the limit")
            max_err = max(max_err, err)
        _batch_invariant("kernel_w4mm", name, lambda x: kern(x, q4, s, torch.float32),
                         torch.randn(64, k, generator=gen, device="cuda").bfloat16())
        wd = dequantize_weight_w4(q4, s, torch.bfloat16, k=k)
        for rows in W4_TIMED_ROWS:
            x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()
            results.append(_w4_row(
                name, rows, lambda: kern(x, q4, s), lambda: plain(x, q4, s),
                lambda: torch.matmul(x, wd),
                q4.numel() + s.numel() * 4 + x.numel() * 2 + rows * n * 2, 2 * rows * k * n,
                flush, k=k, n=n))
    emit("kernel_w4mm", ok=True, name="w4_matmul", max_abs_err=max_err, atol=W4_ATOL,
         rtol=W4_RTOL, timings=results)
    return results[0], max_err


def phase_kernel_w4ffn():
    """w4_ffn at GPT-3B (K 3200, F 8704, N 3200; weights of std 0.02) with 1,
    16, 17 and 64 rows; batch invariance at 64 rows; timed at 16 and 64
    rows."""
    import torch.nn.functional as F

    from controlar_tpu_torch.ops.w4_matmul import (
        dequantize_weight_w4,
        w4_ffn as kern,
        w4_ffn_ref as plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    k, f, n = 3200, 8704, 3200
    q13, s13 = _w4_weight(gen, k, 2 * f)
    q2, s2 = _w4_weight(gen, f, n)
    max_err = 0.0
    for rows in (1, 16, 17, 64):
        x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()
        out = kern(x, q13, s13, q2, s2)
        torch.cuda.synchronize()
        err, ok = _within(out, plain(x, q13, s13, q2, s2), W4_ATOL, W4_RTOL)
        check(ok, "kernel_w4ffn", f"rows={rows}: max_abs_err {err} over the limit")
        max_err = max(max_err, err)
    _batch_invariant("kernel_w4ffn", "ffn", lambda x: kern(x, q13, s13, q2, s2, torch.float32),
                     torch.randn(64, k, generator=gen, device="cuda").bfloat16())
    w13 = dequantize_weight_w4(q13, s13, torch.bfloat16, k=k)
    w2 = dequantize_weight_w4(q2, s2, torch.bfloat16, k=f)
    results = []
    for rows in W4_TIMED_ROWS:
        x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()

        def unfused():  # the library yardstick: bf16 SwiGLU with torch.matmul
            h1, h3 = torch.matmul(x, w13).chunk(2, dim=-1)
            return torch.matmul(F.silu(h1) * h3, w2)

        nbytes = (q13.numel() + q2.numel() + (s13.numel() + s2.numel()) * 4
                  + x.numel() * 2 + rows * n * 2)
        results.append(_w4_row("ffn", rows, lambda: kern(x, q13, s13, q2, s2),
                               lambda: plain(x, q13, s13, q2, s2), unfused, nbytes,
                               2 * rows * (k * 2 * f + f * n), flush, k=k, f=f, n=n))
    emit("kernel_w4ffn", ok=True, name="w4_ffn", max_abs_err=max_err, atol=W4_ATOL,
         rtol=W4_RTOL, timings=results)
    return results[0], max_err


def phase_kernel_q8_append():
    """flash_decode_attention_q8_append at the c2i_w8kv8 shapes (16 rows,
    12 x 64 heads, 768 cache rows): positions 1, 62-64 (each side of a
    64-row chunk boundary), 255, 256, 575, 767 and per slot, with and
    without the caption bias (0 at the decode positions, the kernel's
    contract); the output within the attention kernels' limit and the
    written slabs bit for bit against the plain version. Timed at the last
    step (pos 575, no bias) and at pos 255 with the plain version, SDPA over
    the dequantized slab with the row written, the bound (q and out, the
    live rows and the in-flight row, values and f32 scales, read, the row
    written) and the wrapper's host time. Returns (the last step's row, max
    abs error, launches of the checks)."""
    from controlar_tpu_torch.ops.flash_decode import (
        flash_decode_attention_q8_append as kern,
        flash_decode_attention_q8_append_ref as plain,
    )
    from controlar_tpu_torch.quant import dequantize_kv_slab, quantize_kv_rows

    gen = torch.Generator(device="cuda").manual_seed(17)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b, h, d, s = 16, 12, 64, 768
    q, kv = _slab(gen, b, s, h, d)
    rows, scale = quantize_kv_rows(kv, h)
    new_kv, new_s = quantize_kv_rows(torch.randn(b, 2 * h * d, generator=gen, device="cuda"), h)
    bias = _left_pad_bias(s, 120)
    per_slot = torch.tensor([1, 2, 62, 63, 64, 100, 255, 256, 300, 400, 500, 575, 575, 130, 170,
                             767], dtype=torch.int32, device="cuda")
    max_err = 0.0
    kern.launches = 0
    for pos in (1, 62, 63, 64, 255, 256, 575, 767, per_slot):
        for with_bias in (False, True):
            cb = None
            if with_bias:
                cb = bias.clone()
                p = torch.as_tensor(pos, device="cuda").long().reshape(-1).expand(b)
                cb[torch.arange(b, device="cuda"), p] = 0.0
            kv_k, s_k, kv_p, s_p = rows.clone(), scale.clone(), rows.clone(), scale.clone()
            out, _, _ = kern(q, new_kv, new_s, kv_k, s_k, pos, cb, n_head=h)
            torch.cuda.synchronize()
            want, _, _ = plain(q, new_kv, new_s, kv_p, s_p, pos, cb, n_head=h)
            err, ok = _kernel_error(out, want)
            where = pos if isinstance(pos, int) else "per_slot"
            check(ok, "kernel_q8_append", f"pos={where} bias={with_bias}: max_abs_err {err} "
                  "over the limit")
            check(torch.equal(kv_k, kv_p) and torch.equal(s_k, s_p), "kernel_q8_append",
                  f"pos={where} bias={with_bias}: the written slabs differ")
            max_err = max(max_err, err)
    launches = kern.launches
    timings = []
    for pos in (575, 255):
        kv_k, s_k = rows.clone(), scale.clone()
        kern(q, new_kv, new_s, kv_k, s_k, pos, None, n_head=h)  # the slabs with the row written
        slab = dequantize_kv_slab(kv_k, s_k, h, torch.bfloat16)
        n, row_bytes = pos + 1, 2 * h * d + 2 * h * 4
        bound, by = _roofline(2 * b * h * d * 2 + b * n * row_bytes + b * row_bytes,
                              4 * b * n * h * d, FP32_FLOPS)
        fn = lambda: kern(q, new_kv, new_s, kv_k, s_k, pos, None, n_head=h)  # noqa: E731
        timings.append(dict(
            case="c2i_w8kv8", h=h, d=d, s=s, pos=pos, ms=time_ms(fn, flush=flush),
            plain_ms=time_ms(lambda: plain(q, new_kv, new_s, kv_k, s_k, pos, None, n_head=h),
                             flush=flush),
            library_ms=time_ms(_sdpa(q, slab, n, h, d, None), flush=flush),
            bound_ms=bound, bound_by=by, host_us=host_us(fn)))
    emit("kernel_q8_append", ok=True, name="flash_decode_attention_q8_append",
         max_abs_err=max_err, atol=KERNEL_ATOL, rtol=KERNEL_RTOL, launches=launches,
         timings=timings)
    return timings[0], max_err, launches


# stream, cache dtype, cache rows, row width (elements): what the serving
# decode step wrote at 16 rows (8 slots with CFG) through the single-stream
# append, which no path calls since the fused write took its place
APPEND_STREAMS = (
    ("gpt_b_bf16", torch.bfloat16, 768, 1536),    # [k|v] rows, 3072 B
    ("gpt_b_int8", torch.int8, 768, 1536),        # int8 rows
    ("gpt_b_scales", torch.float32, 768, 24),     # 12-head [k|v] scales, 96 B
    ("gpt_xl_bf16", torch.bfloat16, 1280, 2560),
    ("gpt_3b_int4", torch.int8, 768, 3200),       # nibble carriers
    ("gpt_3b_scales", torch.float32, 768, 64),    # 32-head scales, 256 B
    ("odd_width", torch.int8, 768, 7),            # 1-byte vectors
)

# the fused write's shapes: name, kv heads, head dim, int4 carrier layout
# split, cache rows; each with a bf16, an int8 and an int4 cache. GPT-B is
# also the speculative cells' draft (int4 pairs interleaved at D 64)
KV_WRITE_CASES = (
    ("gpt_b", 12, 64, False, 768),
    ("gpt_xl", 20, 64, False, 1280),
    ("gpt_3b", 32, 100, True, 768),
)
KV_WRITE_KINDS = ("bf16", "int8", "int4")


def _kv_write_inputs(gen, name, kind, t, b=16):
    """A cache of `kind` with random contents and a layer's new rows k, v
    (b, t, KV*D) bf16 as the projections leave them: v a slice of a wqkv
    output (H = KV query heads), k a slice of the rotated [q|k] at GPT-3B
    (split rope), else a contiguous tensor; head 0 of row 0's k is zero (the
    scale's floor). -> (cache, k, v, kv_heads, split)."""
    _, kvh, d, split, s = next(c for c in KV_WRITE_CASES if c[0] == name)
    kvd = kvh * d
    dev = "cuda"
    qkv = (torch.randn(b, t, 3 * kvd, generator=gen, device=dev) * 2).bfloat16()
    v = qkv[..., 2 * kvd:]
    if split:
        k = (torch.randn(b, t, 2 * kvd, generator=gen, device=dev) * 2).bfloat16()[..., kvd:]
    else:
        k = (torch.randn(b, t, kvd, generator=gen, device=dev) * 2).bfloat16()
    k[0, 0, :d] = 0
    if kind == "bf16":
        cache = torch.randn(b, s, 2 * kvd, generator=gen, device=dev).bfloat16()
    else:
        key, width = ("kv", 2 * kvd) if kind == "int8" else ("kv4", kvd)
        cache = {key: torch.randint(-128, 128, (b, s, width), generator=gen, device=dev,
                                    dtype=torch.int8),
                 "s": torch.rand(b, s, 2 * kvh, generator=gen, device=dev) * 0.02}
    return cache, k, v, kvh, split and kind == "int4"


def _clone_cache(cache):
    return {k: t.clone() for k, t in cache.items()} if isinstance(cache, dict) else cache.clone()


def _same_cache(a, b) -> bool:
    if isinstance(a, dict):
        return all(torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8)) for k in a)
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _old_kv_write(cache, k, v, pos, kv_heads, split):
    """The decode paths' write before the fused kernel, as it ran on the
    card: concatenate k and v, quantize with the port's quantizer, then one
    slice assignment (an int pos) or one single-stream append kernel per
    stream."""
    from controlar_tpu_torch.ops.cache_append import (
        cache_append_block, cache_append_rows, cache_streams)

    kv_rows = torch.cat([k, v], dim=-1)
    t = kv_rows.shape[1]
    for dst, src in cache_streams(cache, kv_rows, kv_heads, split):
        if isinstance(pos, int):
            dst[:, pos:pos + t] = src
        elif t == 1:
            cache_append_rows(dst, src[:, 0], pos)
        else:
            cache_append_block(dst, src, pos)
    return cache


def _kv_write_checks(phase, ts, seed):
    """append_kv against its plain version and against the old write
    sequence, bit for bit, on every case and cache kind, at each T in ts,
    with per-row positions that include 0 and S - T and with one int
    position. Returns the checks' launches."""
    from controlar_tpu_torch.ops.cache_append import append_kv as kern
    from controlar_tpu_torch.ops.cache_append import append_kv_ref as plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    launches = kern.launches
    for name, *_ in KV_WRITE_CASES:
        for kind in KV_WRITE_KINDS:
            for t in ts:
                cache, k, v, kvh, split = _kv_write_inputs(gen, name, kind, t)
                s = (cache if kind == "bf16" else cache["s"]).shape[1]
                per_row = torch.tensor([0, s - t] + [(37 * i) % (s - t) for i in range(1, 15)],
                                       dtype=torch.int32, device="cuda")
                for pos in (per_row, s - t):
                    want = plain(_clone_cache(cache), k, v, pos, kv_heads=kvh, split=split)
                    old = _old_kv_write(_clone_cache(cache), k, v, pos, kvh, split)
                    got = kern(_clone_cache(cache), k, v, pos, kv_heads=kvh, split=split)
                    torch.cuda.synchronize()
                    where = f"{name} {kind} T={t} pos={'per_row' if pos is per_row else pos}"
                    check(_same_cache(got, want), phase,
                          f"append_kv {where}: the cache differs from the plain version's")
                    check(_same_cache(got, old), phase,
                          f"append_kv {where}: the cache differs from the old write sequence's")
    return kern.launches - launches


def _kv_write_row(label, name, kind, t, pos, flush, seed):
    """One timed case of append_kv: its time, the plain version's, the old
    write sequence's (cat + quantize + appends, one stretch of CUDA events
    around the whole sequence) and each one's host time a layer write, with
    the bound: k and v read, the rows and scales written, pos read."""
    from controlar_tpu_torch.ops.cache_append import append_kv as kern
    from controlar_tpu_torch.ops.cache_append import append_kv_ref as plain

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache, k, v, kvh, split = _kv_write_inputs(gen, name, kind, t)
    b = k.shape[0]
    if pos == "per_row":
        s = (cache if kind == "bf16" else cache["s"]).shape[1]
        pos = torch.tensor([(37 * i + s - t) % (s - t + 1) for i in range(b)], dtype=torch.int32,
                           device="cuda")
    streams = cache.values() if isinstance(cache, dict) else [cache]
    nbytes = (2 * k.numel() * k.element_size()
              + sum(b * t * st.shape[-1] * st.element_size() for st in streams)
              + (b * 4 if isinstance(pos, torch.Tensor) else 0))
    bound, by = _roofline(nbytes, 0, FP32_FLOPS)
    fused = lambda: kern(cache, k, v, pos, kv_heads=kvh, split=split)  # noqa: E731
    old = lambda: _old_kv_write(cache, k, v, pos, kvh, split)  # noqa: E731
    return dict(case=label, kind=kind, t=t, rows=b, kv_heads=kvh, d=k.shape[-1] // kvh,
                int_pos=not isinstance(pos, torch.Tensor), ms=time_ms(fused, flush=flush),
                old_ms=time_ms(old, flush=flush),
                plain_ms=time_ms(lambda: plain(cache, k, v, pos, kv_heads=kvh, split=split),
                                 flush=flush),
                library_ms=None, bound_ms=bound, bound_by=by, host_us=host_us(fused),
                old_host_us=host_us(old))


def phase_kernel_append():
    """The fused write (append_kv) of a decode step (T = 1) against its plain
    version and the old write sequence, bit for bit, at GPT-B (12 x 64),
    GPT-XL (20 x 64) and GPT-3B (32 x 100, split) on a bf16, an int8 and an
    int4 cache, with strided k / v and a head of zeros; timed at the decode
    cells' steps. Then the single-stream row append (cache_append_rows, on
    no path since the fused write) against its plain version, bit for bit,
    on every stream the serving paths wrote, at per-slot positions that
    include 0 and S-1; timed at the GPT-B bf16 stream, with the plain version
    (one indexed assignment) also the one-call library yardstick. Returns
    {"append_kv": (c2i_3b_w4kv4 row, 0.0), "cache_append_rows": (row, 0.0,
    launches of its checks)}."""
    from controlar_tpu_torch.ops.cache_append import (
        cache_append_rows as kern,
        cache_append_rows_ref as plain,
    )

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fused_launches = _kv_write_checks("kernel_append", (1,), seed=5)
    fused = [_kv_write_row(*case, flush=flush, seed=6) for case in (
        ("c2i_3b_w4kv4 step", "gpt_3b", "int4", 1, 575),
        ("c2i step", "gpt_b", "bf16", 1, 575),
        ("c2i_w8kv8 step", "gpt_b", "int8", 1, 575),
        ("t2i step", "gpt_xl", "bf16", 1, 1142),
        ("serve_c2i step", "gpt_b", "bf16", 1, "per_row"),
        ("serve_c2i_w8kv8 step", "gpt_b", "int8", 1, "per_row"),
        ("spec draft step (w4kv4)", "gpt_b", "int4", 1, "per_row"),
        ("spec draft step (w8kv8)", "gpt_b", "int8", 1, "per_row"))]

    gen = torch.Generator(device="cuda").manual_seed(5)
    b, timed = 16, None
    kern.launches = 0
    for name, dt, s, w in APPEND_STREAMS:
        if dt == torch.int8:
            cache = torch.randint(-128, 128, (b, s, w), generator=gen, device="cuda", dtype=dt)
            rows = torch.randint(-128, 128, (b, w), generator=gen, device="cuda", dtype=dt)
        else:
            cache = torch.randn(b, s, w, generator=gen, device="cuda").to(dt)
            rows = torch.randn(b, w, generator=gen, device="cuda").to(dt)
        pos = torch.tensor([0, s - 1] + [(37 * i) % s for i in range(1, b - 1)],
                           dtype=torch.int32, device="cuda")
        want = plain(cache.clone(), rows, pos)
        kern(cache, rows, pos)
        torch.cuda.synchronize()
        check(torch.equal(cache.view(torch.uint8), want.view(torch.uint8)), "kernel_append",
              f"{name}: the cache differs from the plain version's")
        if timed is None:
            timed = (cache, rows, pos)
    launches = kern.launches
    cache, rows, pos = timed
    nbytes = 2 * rows.numel() * rows.element_size() + pos.numel() * 4  # rows in and out
    bound, by = _roofline(nbytes, 0, FP32_FLOPS)
    plain_ms = time_ms(lambda: plain(cache, rows, pos), flush=flush)
    row = dict(case="gpt_b_bf16", rows=b, row_bytes=rows.shape[1] * rows.element_size(),
               s=cache.shape[1], ms=time_ms(lambda: kern(cache, rows, pos), flush=flush),
               plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound, bound_by=by)
    emit("kernel_append", ok=True, name="append_kv", bit_exact=True,
         cases=[c[0] for c in KV_WRITE_CASES], kinds=KV_WRITE_KINDS, t=[1],
         launches=fused_launches, timings=fused,
         single_stream=dict(name="cache_append_rows", bit_exact=True,
                            streams=[st[0] for st in APPEND_STREAMS], launches=launches,
                            timings=[row]))
    return {"append_kv": (fused[0], 0.0), "cache_append_rows": (row, 0.0, launches)}


def _chunk_cases(with_t2i: bool):
    """(name, heads, head_dim, cache rows, chunk sizes K, positions, with the
    caption bias, timed (K, pos, bias) calls) of the chunk kernels' checks:
    the spec_c2i_3b verify at its last cycles and per-row positions (one
    past the block), the t2i shapes with the left-padded bias including
    chunks inside the prefix (the diagonal exception), K = 1 and 8, and a
    120-query prefill chunk. `_phase_chunk` adds the positions at which the
    last query's visible rows end on each side of a split-kernel chunk
    boundary."""
    def rows(*p):
        return torch.tensor(p, dtype=torch.int32, device="cuda")

    per_row = rows(1, 2, 100, 254, 255, 300, 400, 500, 572, 572, 575, 576, 579, 10, 20, 573)
    cases = [("3b_verify", 32, 100, 768, (4,), (572, per_row), False, ((4, 572, False),)),
             ("3b_k1_k8", 32, 100, 768, (1, 8), (572, per_row), True,
              ((1, 572, False), (8, 572, False)))]
    if with_t2i:
        t2i = rows(0, 3, 100, 117, 119, 120, 500, 1000, 1139, 0, 50, 119, 120, 130, 700, 1100)
        cases += [("t2i_verify", 20, 64, 1280, (4,), (119, 1139, t2i), True, ((4, 1139, True),)),
                  ("t2i_prefill", 20, 64, 1280, (120,), (0,), True, ((120, 0, True),))]
    return cases


def _chunk_row(name, fn, plain, slab, q, h, d, s, pos, row_bytes, bias, flush):
    """Time one chunk-attention call (kernel, plain version, SDPA over the
    first pos + K rows of the (dequantized) bf16 slab with the equivalent
    mask: boolean, or the caption bias off each query's own row) and its
    bound: q and out bf16, row_bytes per live row (values and the f32
    scales of a quantized slab) and the bias row; per value pair and query
    2 flops of q.k on the bf16 tensor cores and 2 of P.V in fp32, each at
    its peak rate. host_us: the wrapper's host time a call."""
    import torch.nn.functional as F

    b, k, hd = q.shape
    n = pos + k
    nbytes = 2 * b * k * hd * 2 + b * n * (row_bytes + 4 * (bias is not None))
    pairs = b * k * n * h * d  # value pairs times queries
    # q.k's bf16 tensor-core flops as the fp32 flops that take the same time
    flops = 2 * pairs + 2 * pairs * FP32_FLOPS / BF16_FLOPS
    bound, by = _roofline(nbytes, flops, FP32_FLOPS)
    q4 = q.view(b, k, h, d).transpose(1, 2)
    k4 = slab[:, :n, :hd].reshape(b, n, h, d).transpose(1, 2)
    v4 = slab[:, :n, hd:].reshape(b, n, h, d).transpose(1, 2)
    cols = torch.arange(n, device="cuda")[None, :]
    own = pos + torch.arange(k, device="cuda")[:, None]
    mask = (cols <= own)[None, None]
    if bias is not None:
        add = torch.where(cols == own, 0.0, bias[:, None, :n])  # (B, K, n)
        mask = torch.where(mask, add[:, None], float("-inf")).bfloat16()
    lib = time_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask), flush=flush)
    return dict(case=name, b=b, k=k, h=h, d=d, s=s, pos=pos, bias=bias is not None,
                ms=time_ms(fn, flush=flush), plain_ms=time_ms(plain, flush=flush), library_ms=lib,
                bound_ms=bound, bound_by=by, host_us=host_us(fn))


def _phase_chunk(phase, kind):
    """One chunk kernel against its plain version over `_chunk_cases`, each
    position with and without the bias where the case has one; timed (with
    host_us) at the spec cell's last verify (16 rows, K = 4, 32 x 100
    heads, S 768, pos 572), the first of the rows, and at K = 1 and 8, the
    t2i verify with the caption bias (bf16, q8) and the 120-query prefill
    chunk. kind: bf16, q8 or q4 (split and interleaved; split timed)."""
    from controlar_tpu_torch.ops import flash_chunk as fc
    from controlar_tpu_torch.quant import (
        dequantize_kv4_slab, dequantize_kv_slab, quantize_kv_rows, quantize_kv_rows_4)

    gen = torch.Generator(device="cuda").manual_seed(11)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    max_err, timings, layouts = 0.0, [], (True, False) if kind == "q4" else (None,)
    for name, h, d, s, ks, positions, with_bias, timed_at in _chunk_cases(kind != "q4"):
        b = 16
        kv = (torch.randn(b, s, 2 * h * d, generator=gen, device="cuda") * 0.5).bfloat16()
        bias = _left_pad_bias(s, 120) if with_bias else None
        for split in layouts:
            if kind == "bf16":
                args, kw = (kv,), {}
                ref, kern = fc.flash_chunk_attention_ref, fc.flash_chunk_attention
                slab, row_bytes = kv, 2 * h * d * 2
            elif kind == "q8":
                rows, scale = quantize_kv_rows(kv, h)
                args, kw = (rows, scale), {}
                ref, kern = fc.flash_chunk_attention_q8_ref, fc.flash_chunk_attention_q8
                slab = dequantize_kv_slab(rows, scale, h, torch.bfloat16)
                row_bytes = 2 * h * d + 2 * h * 4
            else:
                rows, scale = quantize_kv_rows_4(kv, h, split=split)
                args, kw = (rows, scale), dict(head_dim=d, split=split)
                ref, kern = fc.flash_chunk_attention_q4_ref, fc.flash_chunk_attention_q4
                slab = dequantize_kv4_slab(rows, scale, h, d, torch.bfloat16, split=split)
                row_bytes = h * d + 2 * h * 4
            qs = {}
            for kq in ks:
                q = qs[kq] = (torch.randn(b, kq, h * d, generator=gen, device="cuda")
                              * 0.5).bfloat16()
                # the last query's visible rows end one before, on and one after a chunk boundary
                edges = (tuple(max(fc.CHUNK_ROWS + e - kq, 0) for e in (-1, 0, 1))
                         if kq < 120 else ())
                for pos in (*positions, *edges):
                    for col_bias in (None, bias) if with_bias else (None,):
                        out = kern(q, *args, pos, col_bias, n_head=h, **kw)
                        torch.cuda.synchronize()
                        err, ok = _kernel_error(out, ref(q, *args, pos, col_bias, n_head=h, **kw))
                        where = pos if isinstance(pos, int) else "per_row"
                        check(ok, phase, f"{name} K={kq} split={split} pos={where} bias="
                              f"{col_bias is not None}: max_abs_err {err} over the limit")
                        max_err = max(max_err, err)
            if split is False:  # q4: the split layout is the cells' and is timed
                continue
            for kq, at, timed_bias in timed_at:
                q, cb = qs[kq], bias if timed_bias else None
                pos_t = torch.full((b,), at, dtype=torch.int32, device="cuda")
                timings.append(_chunk_row(
                    f"{name}_k{kq}{'' if split is None else '_split'}",
                    lambda: kern(q, *args, pos_t, cb, n_head=h, **kw),
                    lambda: ref(q, *args, pos_t, cb, n_head=h, **kw),
                    slab, q, h, d, s, at, row_bytes, cb, flush))
    emit(phase, ok=True, name=kern.__name__, max_abs_err=max_err, atol=KERNEL_ATOL,
         rtol=KERNEL_RTOL, timings=timings)
    return timings[0], max_err


def phase_kernel_chunk():
    return _phase_chunk("kernel_chunk", "bf16")


def phase_kernel_chunk_q8():
    return _phase_chunk("kernel_chunk_q8", "q8")


def phase_kernel_chunk_q4():
    return _phase_chunk("kernel_chunk_q4", "q4")


# stream, cache dtype, cache rows, row width (elements): what a GPT-3B verify
# wrote at 16 rows (8 images with CFG), K = 4 rows each, through the
# single-stream block append, which no path calls since the fused write
BLOCK_STREAMS = (
    ("gpt_3b_bf16", torch.bfloat16, 768, 6400),   # [k|v] rows, 12800 B
    ("gpt_3b_int8", torch.int8, 768, 6400),       # int8 rows
    ("gpt_3b_scales", torch.float32, 768, 64),    # 32-head [k|v] scales, 256 B
    ("gpt_3b_int4", torch.int8, 768, 3200),       # nibble carriers
    ("gpt_b_scales", torch.float32, 768, 24),     # 12-head scales, 96 B
    ("odd_width", torch.int8, 768, 7),            # 1-byte vectors
)
K_VERIFY = 4


def phase_kernel_append_block():
    """The fused write (append_kv) of a verify chunk (T = 4 and 8) against
    its plain version and the old write sequence, bit for bit, on the cases
    and cache kinds of kernel_append; timed at the spec cells' verify (T =
    4, GPT-3B). Then the single-stream block append (cache_append_block, on
    no path since the fused write) against its plain version, bit for bit,
    on every stream a verify wrote, with blocks at rows 0 and S - K among
    per-row positions; timed at the GPT-3B bf16 stream, the plain version
    (one indexed assignment) also the one-call library yardstick. Returns
    {"cache_append_block": (row, 0.0, launches of its checks)}."""
    from controlar_tpu_torch.ops.cache_append import (
        cache_append_block as kern,
        cache_append_block_ref as plain,
    )

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fused_launches = _kv_write_checks("kernel_append_block", (K_VERIFY, 8), seed=12)
    fused = [_kv_write_row(*case, flush=flush, seed=13) for case in (
        ("spec_c2i_3b_w4kv4 verify", "gpt_3b", "int4", K_VERIFY, "per_row"),
        ("spec_c2i_3b verify", "gpt_3b", "bf16", K_VERIFY, "per_row"),
        ("spec_c2i_3b_w8kv8 verify", "gpt_3b", "int8", K_VERIFY, "per_row"))]

    gen = torch.Generator(device="cuda").manual_seed(12)
    b, k, timed = 16, K_VERIFY, None
    kern.launches = 0
    for name, dt, s, w in BLOCK_STREAMS:
        if dt == torch.int8:
            cache = torch.randint(-128, 128, (b, s, w), generator=gen, device="cuda", dtype=dt)
            rows = torch.randint(-128, 128, (b, k, w), generator=gen, device="cuda", dtype=dt)
        else:
            cache = torch.randn(b, s, w, generator=gen, device="cuda").to(dt)
            rows = torch.randn(b, k, w, generator=gen, device="cuda").to(dt)
        pos = torch.tensor([0, s - k] + [(37 * i) % (s - k) for i in range(1, b - 1)],
                           dtype=torch.int32, device="cuda")
        want = plain(cache.clone(), rows, pos)
        kern(cache, rows, pos)
        torch.cuda.synchronize()
        check(torch.equal(cache.view(torch.uint8), want.view(torch.uint8)), "kernel_append_block",
              f"{name}: the cache differs from the plain version's")
        if timed is None:
            timed = (cache, rows, pos)
    launches = kern.launches
    cache, rows, pos = timed
    nbytes = 2 * rows.numel() * rows.element_size() + pos.numel() * 4  # rows in and out
    bound, by = _roofline(nbytes, 0, FP32_FLOPS)
    plain_ms = time_ms(lambda: plain(cache, rows, pos), flush=flush)
    row = dict(case="gpt_3b_bf16", rows=b, k=k, row_bytes=rows.shape[2] * rows.element_size(),
               s=cache.shape[1], ms=time_ms(lambda: kern(cache, rows, pos), flush=flush),
               plain_ms=plain_ms, library_ms=plain_ms, bound_ms=bound, bound_by=by)
    emit("kernel_append_block", ok=True, name="append_kv", bit_exact=True,
         cases=[c[0] for c in KV_WRITE_CASES], kinds=KV_WRITE_KINDS, t=[K_VERIFY, 8],
         launches=fused_launches, timings=fused,
         single_stream=dict(name="cache_append_block", bit_exact=True,
                            streams=[st[0] for st in BLOCK_STREAMS], launches=launches,
                            timings=[row]))
    return {"cache_append_block": (row, 0.0, launches)}


def _stacked_cases(kind):
    """(name, layers, heads, head_dim, cache rows, split, positions, with the
    caption bias, timed) of the stacked kernels' checks: the cells' last
    decode steps (pos 575 of 768 rows at GPT-B and GPT-3B, 1143 of 1280 at
    t2i GPT-XL with the caption bias), per-slot positions that include 1,
    S - 1 and both sides of the 256-row boundary; for bf16 and int8 also
    both sides of a boundary of their split kernels' 64-row chunks, for
    int4 `_q4_positions` (the boundaries of its chunks at the case's D)."""
    def slots(*p):
        return torch.tensor(p, dtype=torch.int32, device="cuda")

    t2i_slots = slots(120, 121, 200, 400, 631, 700, 800, 900, 1000, 1100, 1142, 1143, 1143,
                      130, 1279, 500)
    # the split kernels' live rows (pos + 1) on each side of a 64-row chunk boundary
    split_slots = slots(1, 2, 62, 63, 64, 100, 255, 256, 300, 400, 500, 575, 575, 10, 50, 767)
    c2i_split = (1, 62, 63, 64, 255, 256, 575, split_slots)
    if kind == "bf16":
        return [("c2i", 12, 12, 64, 768, None, c2i_split, False, True),
                ("t2i", 36, 20, 64, 1280, None, (120, 126, 127, 128, 1143, t2i_slots), True,
                 False)]
    if kind == "q8":
        return [("c2i_w8kv8", 12, 12, 64, 768, None, c2i_split, True, True)]
    return [("3b_split", 24, 32, 100, 768, True, _q4_positions(100), False, True),
            ("b_interleaved", 12, 12, 64, 768, False, _q4_positions(64), True, False)]


def _phase_stacked(phase, kind):
    """One stacked attention kernel against its plain version over
    `_stacked_cases`, at the first and last layer of the stack, each
    position with and without the bias where the case has one; timed at the
    cell's last decode step (16 rows, the last layer, pos 575, no bias) with
    the plain version, SDPA over the layer's (dequantized) slab with the
    in-flight row written (rows 0..575) and the bound: q and out, the 575
    live rows and the in-flight row (values and f32 scales); also at pos 255,
    mid-decode, each row with the wrapper's host time. kind: bf16, q8 or q4
    (split at GPT-3B, interleaved at GPT-B). Returns the last step's row and
    the max abs error."""
    from controlar_tpu_torch.ops import flash_decode_stacked as fds
    from controlar_tpu_torch.quant import (
        dequantize_kv4_slab, dequantize_kv_slab, quantize_kv_rows, quantize_kv_rows_4)

    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b, max_err, timings = 16, 0.0, []
    for name, n_layer, h, d, s, split, positions, with_bias, is_timed in _stacked_cases(kind):
        q = (torch.randn(b, h * d, generator=gen, device="cuda") * 0.5).bfloat16()
        stack = (torch.randn(n_layer, b, s, 2 * h * d, generator=gen, device="cuda")
                 * 0.5).bfloat16()
        new = (torch.randn(b, 2 * h * d, generator=gen, device="cuda") * 0.5).bfloat16()
        if kind == "bf16":
            args, kw = (new, stack), {}
            kern, plain, row_bytes = fds.flash_stacked, fds.flash_stacked_ref, 2 * h * d * 2
        elif kind == "q8":
            rows, sc = quantize_kv_rows(stack, h)
            args, kw = (*quantize_kv_rows(new, h), rows, sc), {}
            kern, plain = fds.flash_stacked_q8, fds.flash_stacked_q8_ref
            row_bytes = 2 * h * d + 2 * h * 4
        else:
            rows, sc = quantize_kv_rows_4(stack, h, split=split)
            args = (*quantize_kv_rows_4(new, h, split=split), rows, sc)
            kw = dict(head_dim=d, split=split)
            kern, plain = fds.flash_stacked_q4, fds.flash_stacked_q4_ref
            row_bytes = h * d + 2 * h * 4
        del stack  # the bf16 stack a quantized case no longer needs
        biases = (None, _left_pad_bias(s, 120)) if with_bias else (None,)
        for layer in (0, n_layer - 1):
            for pos in positions:
                for col_bias in biases:
                    out = kern(q, *args, layer, pos, col_bias, n_head=h, **kw)
                    torch.cuda.synchronize()
                    err, ok = _kernel_error(out, plain(q, *args, layer, pos, col_bias, n_head=h,
                                                       **kw))
                    where = pos if isinstance(pos, int) else "per_slot"
                    check(ok, phase, f"{name} layer={layer} pos={where} bias="
                          f"{col_bias is not None}: max_abs_err {err} over the limit")
                    max_err = max(max_err, err)
        if not is_timed:
            continue
        layer = n_layer - 1
        for pos in (575, 255):
            # the library yardstick: SDPA over the layer's slab with the row written
            if kind == "bf16":
                slab = fds.layer_with_row(args[1], args[0], layer, pos)
            else:
                written = (fds.layer_with_row(args[2], args[0], layer, pos),
                           fds.layer_with_row(args[3], args[1], layer, pos))
                slab = (dequantize_kv_slab(*written, h, torch.bfloat16) if kind == "q8" else
                        dequantize_kv4_slab(*written, h, d, torch.bfloat16, split=split))
            n = pos + 1  # pos rows of the stack and the in-flight row
            bound, by = _roofline(2 * b * h * d * 2 + b * n * row_bytes, 4 * b * n * h * d,
                                  FP32_FLOPS)
            fn = lambda: kern(q, *args, layer, pos, None, n_head=h, **kw)  # noqa: E731
            row = dict(case=name, layers=n_layer, h=h, d=d, s=s, layer=layer, pos=pos,
                       ms=time_ms(fn, flush=flush),
                       plain_ms=time_ms(lambda: plain(q, *args, layer, pos, None, n_head=h,
                                                      **kw), flush=flush),
                       library_ms=time_ms(_sdpa(q, slab, n, h, d, None), flush=flush),
                       bound_ms=bound, bound_by=by, host_us=host_us(fn))
            timings.append(row)
    emit(phase, ok=True, name=kern.__name__, max_abs_err=max_err, atol=KERNEL_ATOL,
         rtol=KERNEL_RTOL, timings=timings)
    return timings[0], max_err


def phase_kernel_stacked():
    return _phase_stacked("kernel_stacked", "bf16")


def phase_kernel_stacked_q8():
    return _phase_stacked("kernel_stacked_q8", "q8")


def phase_kernel_stacked_q4():
    return _phase_stacked("kernel_stacked_q4", "q4")


# stream, cache dtype, row width (elements): what the stacked serving step
# wrote at GPT-B, 12 layers x 16 rows (8 slots with CFG), 768 cache rows,
# through the single-stream stacked append, on no path since the fused
# end-of-step write took its place
STACKED_APPEND_STREAMS = (
    ("gpt_b_bf16", torch.bfloat16, 1536),   # [k|v] rows, 3072 B
    ("gpt_b_int8", torch.int8, 1536),       # int8 rows
    ("gpt_b_int4", torch.int8, 768),        # nibble carriers
    ("gpt_b_scales", torch.float32, 24),    # 12-head [k|v] scales, 96 B
)

# the stacked cells' steps: name, layers, kv heads, head dim, int4 carrier
# layout split, cache rows; GPT-B runs c2i_stacked, c2i_w8kv8_stacked and
# serve_c2i_stacked, GPT-3B c2i_3b_w4kv4_stacked
STACKED_WRITE_CASES = (
    ("gpt_b", 12, 12, 64, False, 768),
    ("gpt_3b", 24, 32, 100, True, 768),
)
STACKED_WRITE_KINDS = ("bf16", "int8", "int4", "int4_pairs")


def _stacked_write_inputs(gen, name, kind, b=16):
    """A stacked cache of `kind` with random contents and one step's new rows
    of every layer, k and v (b, 1, KV*D) bf16 (v a slice of a wqkv output)
    -> (cache, [(k, v) per layer], kv_heads, split). int4 carriers are split
    at GPT-3B unless kind is int4_pairs."""
    _, n_layer, kvh, d, split, s = next(c for c in STACKED_WRITE_CASES if c[0] == name)
    kvd, dev = kvh * d, "cuda"
    if kind == "bf16":
        cache = torch.randn(n_layer, b, s, 2 * kvd, generator=gen, device=dev).bfloat16()
    else:
        key, width = ("kv", 2 * kvd) if kind == "int8" else ("kv4", kvd)
        cache = {key: torch.randint(-128, 128, (n_layer, b, s, width), generator=gen, device=dev,
                                    dtype=torch.int8),
                 "s": torch.rand(n_layer, b, s, 2 * kvh, generator=gen, device=dev) * 0.02}
    new = []
    for _ in range(n_layer):
        qkv = (torch.randn(b, 1, 3 * kvd, generator=gen, device=dev) * 2).bfloat16()
        new.append((qkv[..., kvd:2 * kvd], qkv[..., 2 * kvd:]))
    return cache, new, kvh, split and kind == "int4"


def _new_stacked_write(cache, new, pos, kv_heads, split, rows_only=False):
    """The stacked decode step's writes: each layer's rows quantized into the
    step's in-flight rows by append_kv, then one append_stacked; rows_only:
    the in-flight rows alone (the per-layer launches)."""
    from controlar_tpu_torch.ops.cache_append import (
        append_kv, append_stacked, inflight_layer, stacked_inflight)

    inflight = stacked_inflight(cache, new[0][0].shape[0])
    for l, (k, v) in enumerate(new):
        append_kv(inflight_layer(inflight, l), k, v, 0, kv_heads=kv_heads, split=split)
    return inflight if rows_only else append_stacked(cache, inflight, pos)


def _old_stacked_rows(cache, new, kv_heads, split):
    """The stacked decode step's per-layer writes before the fused ones:
    cat, the port's quantizer, a contiguous copy per stream."""
    from controlar_tpu_torch.ops.cache_append import cache_streams

    inflight = []
    for k, v in new:
        kv_rows = torch.cat([k[:, 0], v[:, 0]], dim=-1)
        inflight.append([src.to(dst.dtype).contiguous()
                         for dst, src in cache_streams(cache, kv_rows, kv_heads, split)])
    return inflight


def _old_stacked_end(cache, inflight, pos):
    """The stacked decode step's end before the fused write: per stream a
    stack of the layers' rows, then an indexed assignment (int pos) or the
    single-stream stacked append."""
    from controlar_tpu_torch.ops.cache_append import cache_append_rows_stacked, stream_list

    for i, dst in enumerate(stream_list(cache)):
        rows = torch.stack([r[i] for r in inflight])
        if isinstance(pos, int):
            dst[:, :, pos] = rows
        else:
            cache_append_rows_stacked(dst, rows, pos)
    return cache


def _stacked_write_checks(gen):
    """append_stacked against its plain version, and the whole step's writes
    (append_kv into the in-flight rows, append_stacked) against the old
    sequence, bit for bit, on every case and cache kind, at an int position
    and at per-slot positions that include 1 and S - 1 (the clamped serving
    step). Returns the checks' launches of append_stacked."""
    from controlar_tpu_torch.ops.cache_append import append_stacked, append_stacked_ref

    launches = append_stacked.launches
    for name, *_ in STACKED_WRITE_CASES:
        for kind in STACKED_WRITE_KINDS:
            cache, new, kvh, split = _stacked_write_inputs(gen, name, kind)
            s = (cache if kind == "bf16" else cache["s"]).shape[2]
            per_row = torch.tensor([1, s - 1] + [(37 * i) % s for i in range(1, 15)],
                                   dtype=torch.int32, device="cuda")
            for pos in (per_row, s - 1):
                inflight = _new_stacked_write(_clone_cache(cache), new, pos, kvh, split,
                                              rows_only=True)
                want = append_stacked_ref(_clone_cache(cache), inflight, pos)
                got = append_stacked(_clone_cache(cache), inflight, pos)
                old = _old_stacked_end(_clone_cache(cache),
                                       _old_stacked_rows(cache, new, kvh, split), pos)
                torch.cuda.synchronize()
                where = f"{name} {kind} pos={'per_row' if pos is per_row else pos}"
                check(_same_cache(got, want), "kernel_append_stacked",
                      f"append_stacked {where}: the cache differs from the plain version's")
                check(_same_cache(got, old), "kernel_append_stacked",
                      f"append_stacked {where}: the cache differs from the old sequence's")
    return append_stacked.launches - launches


def _stacked_library(dsts, srcs, pos):
    """The one-call library yardstick of a stacked write with one stream:
    the bare index_put_ `dst[:, arange(B), pos] = src` (a slice copy at an
    int pos), without the plain version's range check; None where there are
    two streams (rows and scales), which no one call writes."""
    if len(dsts) != 1:
        return None
    (dst,), (src,) = dsts, srcs
    if isinstance(pos, int):
        slots, at = slice(None), pos
    else:
        slots, at = torch.arange(dst.shape[1], device=dst.device), pos.long()

    def write():
        dst[:, slots, at] = src

    return write


def _stacked_write_row(label, name, kind, pos, flush, seed):
    """One timed stacked step's writes: the end-of-step append_stacked, its
    plain version and the old end (stack + a write per stream), each with
    host us a call; and the whole step's writes, fused (L append_kv + one
    append_stacked) and old (L x (cat + quantizer + copies) + the old end),
    each as one stretch of CUDA events. Bound: the in-flight rows read and
    written once, pos read."""
    from controlar_tpu_torch.ops.cache_append import (
        append_stacked, append_stacked_ref, stream_list)

    gen = torch.Generator(device="cuda").manual_seed(seed)
    cache, new, kvh, split = _stacked_write_inputs(gen, name, kind)
    n_layer, b, s = stream_list(cache)[0].shape[:3]
    if pos == "per_row":
        pos = torch.tensor([(37 * i + 1) % s for i in range(b)], dtype=torch.int32,
                           device="cuda").clamp_(min=1)
    inflight = _new_stacked_write(cache, new, pos, kvh, split, rows_only=True)
    old_rows = _old_stacked_rows(cache, new, kvh, split)
    nbytes = (2 * sum(x.numel() * x.element_size() for x in stream_list(inflight))
              + (b * 4 if isinstance(pos, torch.Tensor) else 0))
    bound, by = _roofline(nbytes, 0, FP32_FLOPS)
    end = lambda: append_stacked(cache, inflight, pos)  # noqa: E731
    old_end = lambda: _old_stacked_end(cache, old_rows, pos)  # noqa: E731
    lib = _stacked_library(stream_list(cache), stream_list(inflight), pos)
    return dict(case=label, kind=kind, layers=n_layer, rows=b, kv_heads=kvh,
                streams=len(stream_list(cache)), int_pos=not isinstance(pos, torch.Tensor),
                ms=time_ms(end, flush=flush), old_ms=time_ms(old_end, flush=flush),
                plain_ms=time_ms(lambda: append_stacked_ref(cache, inflight, pos), flush=flush),
                library_ms=None if lib is None else time_ms(lib, flush=flush),
                bound_ms=bound, bound_by=by, host_us=host_us(end),
                old_host_us=host_us(old_end),
                step_ms=time_ms(lambda: _new_stacked_write(cache, new, pos, kvh, split),
                                flush=flush),
                old_step_ms=time_ms(lambda: _old_stacked_end(
                    cache, _old_stacked_rows(cache, new, kvh, split), pos), flush=flush))


def phase_kernel_append_stacked():
    """The stacked cache's end-of-step write (append_stacked, one launch for
    every stream) against its plain version, and the step's writes (append_kv
    into the in-flight rows a layer, then append_stacked) against the old
    sequence (cat + quantizer + copies a layer, a stack and a write per
    stream), bit for bit, at GPT-B and GPT-3B on bf16, int8 and int4 (split
    and interleaved) caches, int and per-slot positions; timed at the
    stacked cells' steps. Then the single-stream stacked append
    (cache_append_rows_stacked, on no path since the fused write) against its
    plain version, bit for bit, on every stream of the stacked cache at the
    serve_c2i shape, positions 0 and S - 1 among per-slot ones; timed at the
    bf16 stream, the bare index_put_ its one-call library yardstick.
    Returns {"append_stacked": (serve_c2i_stacked row, 0.0),
    "cache_append_rows_stacked": (row, 0.0, launches of its checks)}."""
    from controlar_tpu_torch.ops.cache_append import (
        cache_append_rows_stacked as kern,
        cache_append_rows_stacked_ref as plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(14)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    fused_launches = _stacked_write_checks(gen)
    fused = [_stacked_write_row(*case, flush=flush, seed=15) for case in (
        ("serve_c2i_stacked step", "gpt_b", "bf16", "per_row"),
        ("c2i_stacked step", "gpt_b", "bf16", 575),
        ("c2i_w8kv8_stacked step", "gpt_b", "int8", 575),
        ("c2i_3b_w4kv4_stacked step", "gpt_3b", "int4", 575))]

    n_layer, b, s, timed = 12, 16, 768, None
    kern.launches = 0
    for name, dt, w in STACKED_APPEND_STREAMS:
        if dt == torch.int8:
            cache = torch.randint(-128, 128, (n_layer, b, s, w), generator=gen, device="cuda",
                                  dtype=dt)
            rows = torch.randint(-128, 128, (n_layer, b, w), generator=gen, device="cuda",
                                 dtype=dt)
        else:
            cache = torch.randn(n_layer, b, s, w, generator=gen, device="cuda").to(dt)
            rows = torch.randn(n_layer, b, w, generator=gen, device="cuda").to(dt)
        pos = torch.tensor([0, s - 1] + [(37 * i) % s for i in range(1, b - 1)],
                           dtype=torch.int32, device="cuda")
        want = plain(cache.clone(), rows, pos)
        kern(cache, rows, pos)
        torch.cuda.synchronize()
        check(torch.equal(cache.view(torch.uint8), want.view(torch.uint8)),
              "kernel_append_stacked", f"{name}: the cache differs from the plain version's")
        if timed is None:
            timed = (cache, rows, pos)
    launches = kern.launches
    cache, rows, pos = timed
    nbytes = 2 * rows.numel() * rows.element_size() + pos.numel() * 4  # rows in and out
    bound, by = _roofline(nbytes, 0, FP32_FLOPS)
    row = dict(case="gpt_b_bf16", layers=n_layer, rows=b,
               row_bytes=rows.shape[2] * rows.element_size(), s=s,
               ms=time_ms(lambda: kern(cache, rows, pos), flush=flush),
               plain_ms=time_ms(lambda: plain(cache, rows, pos), flush=flush),
               library_ms=time_ms(_stacked_library([cache], [rows], pos), flush=flush),
               bound_ms=bound, bound_by=by)
    emit("kernel_append_stacked", ok=True, name="append_stacked", bit_exact=True,
         cases=[c[0] for c in STACKED_WRITE_CASES], kinds=STACKED_WRITE_KINDS,
         launches=fused_launches, timings=fused,
         single_stream=dict(name="cache_append_rows_stacked", bit_exact=True,
                            streams=[st[0] for st in STACKED_APPEND_STREAMS],
                            launches=launches, timings=[row]))
    return {"append_stacked": (fused[0], 0.0), "cache_append_rows_stacked": (row, 0.0, launches)}


# Training attention kernels vs their plain versions: |out - ref| <= TRAIN_ATOL +
# TRAIN_RTOL * |ref|. The forward's p is rounded to bf16 against the running
# max in the kernel and against the row max in the plain version (2**-9
# relative each), and out is rounded to bf16 (2**-8); dq, dk and dv sum T
# products of bf16-rounded ds or p, where an fp32 difference in the scores
# can flip one rounding (2**-8 of that term). |out| and the gradients are
# O(1) at these inputs; a dropped key tile or a misapplied bias moves them
# by O(0.1).
TRAIN_ATOL, TRAIN_RTOL = 2e-2, 2e-2
# lse = m + log l is fp32 on both sides, the sums in another order; |lse| is
# O(5), and one dropped key tile of the XL layer's 18 moves it by about 0.06
TRAIN_LSE_ATOL, TRAIN_LSE_RTOL = 1e-3, 1e-4


def _train_cases():
    """name, B, T, H, D, left-padded caption columns (0: no bias): the two
    training cells' shapes, a c2i case without bias, GPT-3B heads, and the
    multiscale phase's budget bucket (1024 x 576 px: 2304 tokens)."""
    return [("t2i_xl512", 8, 1143, 20, 64, 120), ("t2i_b256", 16, 375, 12, 64, 120),
            ("c2i_b384", 4, 576, 12, 64, 0), ("d100", 2, 333, 32, 100, 120),
            ("t2i_xl_ms2304", 8, 2423, 20, 64, 120)]


def _train_inputs(b, t, h, d, n_cls, seed):
    """q, k, v, dO (B, T, H, D) bf16, the column bias (or None) and the
    valid rows; dO is zero on the fully masked rows, as in the model."""
    from controlar_tpu_torch.cells import train_caption_lens
    from controlar_tpu_torch.ops.flash_train import key_bias

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn(b, t, h, d, generator=gen, device="cuda").bfloat16()
                   for _ in range(4))
    valid = torch.ones(b, t, dtype=torch.bool, device="cuda")
    if n_cls:
        lens = torch.as_tensor(train_caption_lens(b, seed), device="cuda")
        valid[:, :n_cls] = torch.arange(n_cls, device="cuda")[None, :] >= (n_cls - lens)[:, None]
    do = do * valid[:, :, None, None]
    return q, k, v, do, (key_bias(valid) if n_cls else None), valid


def _train_bound(kind, b, t, h, d, with_bias):
    """Least time for one call: causal (query, key) pairs; the forward does
    two products (4 D flops a pair), dq three, dk/dv four, in bf16 on the
    tensor cores; bytes: each bf16 tensor read or written once, lse, delta
    and the bias in f32."""
    pairs = b * h * t * (t + 1) // 2
    elem = b * t * h * d * 2
    f32_rows = b * h * t * 4
    n_bf16, n_f32, products = {"fwd": (4, 1, 2), "dq": (5, 2, 3), "dkv": (6, 2, 4)}[kind]
    nbytes = n_bf16 * elem + n_f32 * f32_rows + (b * t * 4 if with_bias else 0)
    return _roofline(nbytes, 2 * products * d * pairs, BF16_FLOPS)


def _sdpa_train(q, k, v, valid):
    """The library yardstick: SDPA with a boolean mask, causal & (key_valid
    | diagonal) so that no row is empty, over (B, H, T, D) views; returns
    the forward and the autograd backward of dq, dk, dv (never called by
    the port)."""
    import torch.nn.functional as F

    t = q.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    eye = torch.eye(t, dtype=torch.bool, device=q.device)
    mask = (causal[None] & (valid[:, None, :] | eye[None]))[:, None]
    qh, kh, vh = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

    out = fwd()
    do = torch.randn_like(out)
    return fwd, lambda: torch.autograd.grad(out, (qh, kh, vh), do, retain_graph=True)


def _sdpa_causal(q, k, v):
    """The library yardstick where there is no bias: SDPA with is_causal=True
    over (B, H, T, D) views (never called by the port)."""
    import torch.nn.functional as F

    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)


def phase_kernel_train():
    """flash_train_fwd, flash_train_dq and flash_train_dkv against their
    plain versions at the training cells' shapes (left-padded caption bias),
    a c2i case without bias and GPT-3B heads (D = 100); each timed at every
    case with the plain version, SDPA and the bound. Emits one phase per
    kernel; returns {kernel: (the XL cell's row, max abs error)}."""
    from controlar_tpu_torch.ops import flash_train as ft

    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    rows = collections.defaultdict(list)
    errs = collections.defaultdict(float)
    for i, (name, b, t, h, d, n_cls) in enumerate(_train_cases()):
        q, k, v, do, bias, valid = _train_inputs(b, t, h, d, n_cls, seed=40 + i)
        out_ref, lse_ref = ft.flash_train_fwd_ref(q, k, v, bias)
        delta = (do.float() * out_ref.float()).sum(-1).transpose(1, 2).contiguous()
        dq_ref, dk_ref, dv_ref = ft.flash_train_bwd_ref(q, k, v, bias, do, lse_ref, delta)
        out, lse = ft.flash_train_fwd(q, k, v, bias)
        dq = ft.flash_train_dq(q, k, v, bias, do, lse_ref, delta)
        dk, dv = ft.flash_train_dkv(q, k, v, bias, do, lse_ref, delta)
        torch.cuda.synchronize()
        rowmask = valid[:, :, None, None]
        lse_rows = valid[:, None, :].expand(b, h, t)
        train_tol, lse_tol = (TRAIN_ATOL, TRAIN_RTOL), (TRAIN_LSE_ATOL, TRAIN_LSE_RTOL)
        checks = {  # fully masked rows are junk: out and lse compared on valid rows
            "flash_train_fwd": [(out * rowmask, out_ref * rowmask, train_tol),
                                (lse.where(lse_rows, 0.0), lse_ref.where(lse_rows, 0.0),
                                 lse_tol)],
            "flash_train_dq": [(dq, dq_ref, train_tol)],
            "flash_train_dkv": [(dk, dk_ref, train_tol), (dv, dv_ref, train_tol)],
        }
        for kern, pairs in checks.items():
            for got, want, (atol, rtol) in pairs:
                err, ok = _within(got, want, atol, rtol)
                check(ok, "kernel_train", f"{kern} {name}: max_abs_err {err} over the limit")
                errs[kern] = max(errs[kern], err)
        lib_fwd, lib_bwd = _sdpa_train(q, k, v, valid)
        lib_fwd_ms, lib_bwd_ms = time_ms(lib_fwd, flush=flush), time_ms(lib_bwd, flush=flush)
        # without a bias the function is causal SDPA's: the library's causal kernel
        causal_ms = None if n_cls else time_ms(_sdpa_causal(q, k, v), flush=flush)
        calls = {
            "flash_train_fwd": (lambda: ft.flash_train_fwd(q, k, v, bias),
                                lambda: ft.flash_train_fwd_ref(q, k, v, bias), lib_fwd_ms, "fwd"),
            "flash_train_dq": (lambda: ft.flash_train_dq(q, k, v, bias, do, lse_ref, delta),
                               lambda: ft.flash_train_bwd_ref(q, k, v, bias, do, lse_ref, delta),
                               lib_bwd_ms, "dq"),
            "flash_train_dkv": (lambda: ft.flash_train_dkv(q, k, v, bias, do, lse_ref, delta),
                                lambda: ft.flash_train_bwd_ref(q, k, v, bias, do, lse_ref,
                                                               delta), lib_bwd_ms, "dkv"),
        }
        for kern, (fn, plain, lib, kind) in calls.items():
            bound, by = _train_bound(kind, b, t, h, d, bias is not None)
            row = dict(case=name, b=b, t=t, h=h, d=d, bias=bias is not None,
                       ms=time_ms(fn, flush=flush), plain_ms=time_ms(plain, flush=flush),
                       library_ms=lib, bound_ms=bound, bound_by=by)
            if kind == "fwd":
                row.update(variant=ft.fwd_variant(d), host_us=host_us(fn))
                if causal_ms is not None:
                    row["library_causal_ms"] = causal_ms
            rows[kern].append(row)
        del q, k, v, do, out_ref, dq_ref, dk_ref, dv_ref, out, dq, dk, dv, lib_fwd, lib_bwd
        torch.cuda.empty_cache()
    phases = {"flash_train_fwd": "kernel_train_fwd", "flash_train_dq": "kernel_train_dq",
              "flash_train_dkv": "kernel_train_dkv"}
    for kern, phase in phases.items():
        emit(phase, ok=True, name=kern, max_abs_err=errs[kern], atol=TRAIN_ATOL,
             rtol=TRAIN_RTOL, library="SDPA, boolean mask" + (
                 "; library_causal_ms: SDPA is_causal=True, at the case without a bias"
                 if kern == "flash_train_fwd" else ", autograd backward (dq, dk, dv)"),
             **({"lse_atol": TRAIN_LSE_ATOL, "lse_rtol": TRAIN_LSE_RTOL}
                if kern == "flash_train_fwd" else {}),
             timings=rows[kern])
    return {kern: (rows[kern][0], errs[kern]) for kern in phases}


def phase_reference():
    """A small fp32 model on the card (kernel path) against the same weights
    on the CPU (plain path): Canny bit for bit, the adapter, prefill and
    three decode steps with the per-layer and with the stacked cache, and
    the VQ decoder; then the quantized models likewise."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.config import GPTConfig, VQConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.ops.canny import canny

    errs = {}
    img = condition_images(2, 128, seed=5)
    edges_gpu = canny(torch.from_numpy(img).cuda()).cpu()
    edges_cpu = canny(torch.from_numpy(img))
    check(torch.equal(edges_gpu, edges_cpu), "reference", "canny differs between card and CPU")

    acfg = tvit.ViTConfig(hidden_size=64, n_layer=2, n_head=2, pos_grid=4)
    vit_cpu = tvit.init_vit(acfg, seed=3)
    x = torch.randn(2, 84, 70, 3, generator=torch.Generator().manual_seed(0))
    errs["adapter"] = (tvit.vit_forward(vit_cpu.cuda(), acfg, x.cuda()).cpu()
                       - tvit.vit_forward(vit_cpu.cpu(), acfg, x)).abs().max().item()

    vcfg = VQConfig(codebook_size=64, z_channels=32, ch=32, decoder_ch_mult=(1, 2, 2))
    vq_cpu = tvq.init_vq(vcfg, seed=4)
    idx = torch.randint(0, 64, (2, 4, 5), generator=torch.Generator().manual_seed(1))
    errs["vq"] = (tvq.decode_code(vq_cpu.cuda(), vcfg, idx.cuda()).cpu()
                  - tvq.decode_code(vq_cpu.cpu(), vcfg, idx)).abs().max().item()

    cfg = GPTConfig(model_type="t2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    caption_dim=32, cls_token_num=5, block_size=16)
    gpt = tgpt.init_gpt(cfg, seed=2)
    torch.nn.init.normal_(gpt.output.weight, std=0.02)  # the t2i head is zero at init
    gen = torch.Generator().manual_seed(6)
    prefix = torch.randn(3, 5, 128, generator=gen)
    fused3 = torch.randn(3, 3, 16, 128, generator=gen) * 0.5
    col_mask = torch.arange(5)[None, :] >= torch.tensor([0, 2, 4])[:, None]
    toks = torch.randint(0, 64, (3, 3), generator=gen)
    for stacked in (False, True):
        init = tdec.init_stacked_caches if stacked else tdec.init_flat_caches
        logits = {}
        for dev in ("cuda", "cpu"):
            gpt = gpt.to(dev)
            caches = init(cfg, 3, 256, torch.bfloat16, dev)
            lg, caches = tdec.prefill_flat(gpt, cfg, caches, prefix.to(dev), fused3.to(dev),
                                           col_mask.to(dev))
            out = [lg.cpu()]
            full = torch.cat([col_mask, torch.ones(3, 251, dtype=torch.bool)], 1).to(dev)
            for i in range(3):
                lg, caches = tdec.decode_step_flat(gpt, cfg, caches, toks[:, i].to(dev), 5 + i,
                                                   fused3.to(dev), full, use_flash=True)
                out.append(lg.cpu())
            logits[dev] = torch.stack(out)
        errs["logits_stacked" if stacked else "logits"] = (
            logits["cuda"] - logits["cpu"]).abs().max().item()
    for k, v in errs.items():
        check(v <= REF_TOL, "reference", f"{k}: card vs CPU max_abs_err {v} > {REF_TOL}")
    quant_errs = {name + "_stacked" * stacked: _quantized_reference(mode, cache, stacked)
                  for name, mode, cache in (("w8_kv8", "int8", torch.int8),
                                            ("w4split_kv4", "w4", "int4"))
                  for stacked in (False, True)}
    for name, (err, scale) in quant_errs.items():
        tol = QUANT_REF_TOL[name.removesuffix("_stacked")]
        check(err <= tol * scale, "reference",
              f"{name}: card vs CPU max_abs_err {err} > {tol} * {scale}")
    emit("reference", ok=True, canny_bit_exact=True, max_abs_err=errs, tol=REF_TOL,
         quantized_max_abs_err={k: v[0] for k, v in quant_errs.items()},
         quantized_logit_scale={k: v[1] for k, v in quant_errs.items()},
         quantized_tol_relative=QUANT_REF_TOL)


# Card (kernels) vs CPU (plain route), relative to max |logit|:
# - W8 + int8 cache: both take fp32 products; the card's sums run in another
#   order, which can flip a rare int8 rounding of a cache row (one step is
#   1/127 of a head's max);
# - W4 + int4 cache: on the CPU W4 takes the JAX package's fallback (weights
#   dequantized to bf16, x kept fp32), the kernel rounds x to bf16 and keeps
#   fp32 scales; each rounds ~2**-9 relative per product (a few 1e-3 of the
#   logits after three layers), and a flipped int4 rounding of a cache row
#   moves that value by 1/7 of its head's max.
QUANT_REF_TOL = {"w8_kv8": 2e-3, "w4split_kv4": 2e-2}


def _quantized_reference(mode: str, cache_dtype, stacked: bool = False):
    """Prefill and three decode steps of a small quantized t2i model (head
    dim 64, W4-compatible widths, a column mask) on the card, kernels on,
    and on the CPU, with the per-layer or the stacked cache; -> (max abs
    logit difference, max |logit| on the CPU)."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.quant import quantize_gpt

    cfg = GPTConfig(model_type="t2i", dim=256, n_layer=3, n_head=4, vocab_size=64,
                    caption_dim=32, cls_token_num=5, block_size=16)
    gpt = tgpt.init_gpt(cfg, seed=2)
    torch.nn.init.normal_(gpt.output.weight, std=0.02)  # the t2i head is zero at init
    quantize_gpt(gpt, cfg, mode=mode, split_rope=mode == "w4")
    gen = torch.Generator().manual_seed(7)
    prefix = torch.randn(3, 5, 256, generator=gen)
    fused3 = torch.randn(3, 3, 16, 256, generator=gen) * 0.5
    col_mask = torch.arange(5)[None, :] >= torch.tensor([0, 2, 4])[:, None]
    toks = torch.randint(0, 64, (3, 3), generator=gen)
    logits = {}
    init = tdec.init_stacked_caches if stacked else tdec.init_flat_caches
    for dev in ("cuda", "cpu"):
        gpt = gpt.to(dev)
        caches = init(cfg, 3, 256, cache_dtype, dev)
        lg, caches = tdec.prefill_flat(gpt, cfg, caches, prefix.to(dev), fused3.to(dev),
                                       col_mask.to(dev))
        out = [lg.cpu()]
        full = torch.cat([col_mask, torch.ones(3, 251, dtype=torch.bool)], 1).to(dev)
        for i in range(3):
            lg, caches = tdec.decode_step_flat(gpt, cfg, caches, toks[:, i].to(dev), 5 + i,
                                               fused3.to(dev), full, use_flash=True)
            out.append(lg.cpu())
        logits[dev] = torch.stack(out)
    return ((logits["cuda"] - logits["cpu"]).abs().max().item(),
            logits["cpu"].abs().max().item())


def _multi_reference(mode, cache_dtype, stacked: bool = False):
    """Prefill and three per-slot decode steps (`decode_step_multi`) of a
    small t2i model with a column mask and per-row control strengths, on the
    card (kernels on) and on the CPU (their plain versions), with the
    per-layer or the stacked cache (which moves the never-admitted row to
    position 1). Rows start at positions 5, 8, 6 and 0 and advance by 1, 1,
    0 and 0: a frozen slot and a never-admitted one. mode None keeps fp32
    weights (bf16 cache).
    -> (max abs logit difference over the first three rows, max |logit| on
    the CPU, max abs logit difference of the never-admitted row). That row
    attends to one cache row with weight 1, so a flipped int4 rounding of it
    moves its output by up to 1/7 of a head's max (1-2% of the logits where
    the other rows see 0.1-0.3%, in a CPU emulation of the kernels'
    numerics); the engine discards its logits, so it is reported, not held
    to the limit."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.quant import quantize_gpt

    cfg = GPTConfig(model_type="t2i", dim=256, n_layer=3, n_head=4, vocab_size=64,
                    caption_dim=32, cls_token_num=5, block_size=16)
    gpt = tgpt.init_gpt(cfg, seed=2)
    gen = torch.Generator().manual_seed(8)
    torch.nn.init.normal_(gpt.output.weight, std=0.02, generator=gen)  # zero at init (t2i)
    if mode is not None:
        quantize_gpt(gpt, cfg, mode=mode, split_rope=mode == "w4")
    prefix = torch.randn(4, 5, 256, generator=gen)
    fused3 = torch.randn(3, 4, 16, 256, generator=gen) * 0.5
    col_mask = torch.arange(5)[None, :] >= torch.tensor([0, 2, 4, 0])[:, None]
    full = torch.cat([col_mask, torch.ones(4, 251, dtype=torch.bool)], 1)
    toks = torch.randint(0, 64, (4, 3), generator=gen)
    strength = torch.tensor([0.8, 1.0, 1.2, 0.5])[:, None, None]
    pos0, advance = torch.tensor([5, 8, 6, 0], dtype=torch.int32), torch.tensor([1, 1, 0, 0])
    logits = {}
    init = tdec.init_stacked_caches if stacked else tdec.init_flat_caches
    for dev in ("cuda", "cpu"):
        gpt = gpt.to(dev)
        caches = init(cfg, 4, 256, cache_dtype or torch.bfloat16, dev)
        lg, caches = tdec.prefill_flat(gpt, cfg, caches, prefix.to(dev), fused3.to(dev),
                                       col_mask.to(dev))
        out, pos = [lg.cpu()], pos0
        for i in range(3):
            lg, caches = tdec.decode_step_multi(
                gpt, cfg, caches, toks[:, i].to(dev), pos.to(dev), fused3.to(dev),
                control_strength=strength.to(dev), use_flash=True, col_mask_full=full.to(dev))
            out.append(lg.cpu())
            pos = (pos + advance).int()
        logits[dev] = torch.stack(out)
    diff = (logits["cuda"] - logits["cpu"]).abs()
    check(bool(torch.isfinite(logits["cuda"]).all()), "serve_reference",
          f"{mode}: non-finite logits on the card")
    return (diff[:, :3].max().item(), logits["cpu"].abs().max().item(),
            diff[:, 3].max().item())


def phase_serve_reference():
    """Per-slot decode steps, card against CPU, for the bf16 (fp32 weights),
    W8 + int8-cache and W4 split-rope + int4-cache models, with the
    per-layer and with the stacked cache; then request 0 of a small bf16
    serving engine alone and with a neighbour admitted one step() later:
    identical sampled tokens on the card, with either cache."""
    from controlar_tpu_torch.cells import serve_requests, serve_staggered
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.serve import ServeConfig, ServeEngine

    errs = {}
    for stacked in (False, True):
        sfx = "_stacked" * stacked
        err = errs["bf16" + sfx] = _multi_reference(None, None, stacked)
        check(err[0] <= REF_TOL, "serve_reference",
              f"bf16{sfx}: card vs CPU max_abs_err {err[0]} > {REF_TOL}")
        for name, mode, cache in (("w8_kv8", "int8", torch.int8),
                                  ("w4split_kv4", "w4", "int4")):
            err, scale, _ = errs[name + sfx] = _multi_reference(mode, cache, stacked)
            tol = QUANT_REF_TOL[name]
            check(err <= tol * scale, "serve_reference",
                  f"{name}{sfx}: card vs CPU max_abs_err {err} > {tol} * {scale}")

    cfg = GPTConfig(model_type="c2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, block_size=16)
    model = tgpt.init_gpt(cfg, seed=0, dtype=torch.bfloat16, device="cuda")

    def run(n, stacked):
        eng = ServeEngine(model, cfg, ServeConfig(max_slots=2, quantum=6, top_k=8,
                                                  kv_stacked=stacked), device="cuda")
        return serve_staggered(eng, serve_requests(n, num_classes=10), upfront=1,
                               add_after_step=1)

    for stacked in (False, True):
        # request 0 alone: slot 1 is never admitted (the stacked step's clamp)
        solo, duo = run(1, stacked), run(2, stacked)
        check(np.array_equal(solo[0].tokens, duo[0].tokens), "serve_reference",
              f"stacked={stacked}: request 0's tokens depend on its neighbour")
        check(not np.array_equal(duo[0].tokens, duo[1].tokens), "serve_reference",
              f"stacked={stacked}: the two requests gave the same tokens")
    emit("serve_reference", ok=True, max_abs_err={k: v[0] for k, v in errs.items()},
         logit_scale={k: v[1] for k, v in errs.items()},
         never_admitted_row_max_abs_err={k: v[2] for k, v in errs.items()},
         tol_bf16_abs=REF_TOL,
         tol_quantized_relative=QUANT_REF_TOL, slot_isolation=True)


def _chunk_reference(mode, cache_dtype):
    """Prefill and two verify cycles (`forward_chunk`, K = 4, per-row base
    positions, one chunk past the block) of a small t2i model with a column
    mask, on the card (kernels on) and on the CPU (their plain versions).
    mode None keeps fp32 weights (bf16 cache). -> (max abs logit difference,
    max |logit| on the CPU)."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch import spec_decode as tspec
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.quant import quantize_gpt

    cfg = GPTConfig(model_type="t2i", dim=256, n_layer=3, n_head=4, vocab_size=64,
                    caption_dim=32, cls_token_num=5, block_size=16)
    gpt = tgpt.init_gpt(cfg, seed=2)
    gen = torch.Generator().manual_seed(9)
    torch.nn.init.normal_(gpt.output.weight, std=0.02, generator=gen)  # zero at init (t2i)
    if mode is not None:
        quantize_gpt(gpt, cfg, mode=mode, split_rope=mode == "w4")
    prefix = torch.randn(4, 5, 256, generator=gen)
    fused3 = torch.randn(3, 4, 16, 256, generator=gen) * 0.5
    col_mask = torch.arange(5)[None, :] >= torch.tensor([0, 2, 4, 0])[:, None]
    full = torch.cat([col_mask, torch.ones(4, 251, dtype=torch.bool)], 1)
    toks = torch.randint(0, 64, (2, 4, 4), generator=gen)
    pos0 = torch.tensor([5, 9, 18, 6], dtype=torch.int32)  # row 2: past the block
    logits = {}
    for dev in ("cuda", "cpu"):
        gpt = gpt.to(dev)
        caches = tdec.init_flat_caches(cfg, 4, 256, cache_dtype or torch.bfloat16, dev)
        lg, caches = tdec.prefill_flat(gpt, cfg, caches, prefix.to(dev), fused3.to(dev),
                                       col_mask.to(dev))
        out = [lg.cpu()[:, None]]
        for i in range(2):
            lg, caches = tspec.forward_chunk(gpt, cfg, caches, toks[i].to(dev),
                                             (pos0 + 4 * i).to(dev), fused3.to(dev),
                                             full.to(dev), use_flash=True)
            out.append(lg.cpu())
        logits[dev] = torch.cat(out, dim=1)
    check(bool(torch.isfinite(logits["cuda"]).all()), "spec_reference",
          f"{mode}: non-finite logits on the card")
    return ((logits["cuda"] - logits["cpu"]).abs().max().item(),
            logits["cpu"].abs().max().item())


def _greedy_margin(model, cfg, labels, tokens, i, cfg_scale):
    """Top-2 margin and max |logit| of the plain loop's CFG-mixed logits at
    token i, teacher-forced with `tokens` on the card."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.generate import cfg_mix, prepare_inputs

    with torch.inference_mode():
        prefix, _, _ = prepare_inputs(model, cfg, torch.device("cuda"), True, labels=labels)
        caches = tdec.init_flat_caches(cfg, prefix.shape[0], 256, torch.bfloat16, "cuda")
        lg, caches = tdec.prefill_flat(model, cfg, caches, prefix, None, None)
        for j in range(i):
            cur = torch.cat([tokens[:, j], tokens[:, j]])
            lg, caches = tdec.decode_step_flat(model, cfg, caches, cur, cfg.cls_token_num + j,
                                               None, None)
        mixed = cfg_mix(lg, True, cfg_scale)
        top2 = mixed.topk(2, dim=-1).values
        return (top2[:, 0] - top2[:, 1]).min().item(), mixed.abs().max().item()


def phase_spec_reference():
    """forward_chunk card vs CPU for the fp32 (bf16 cache), W8 + int8-cache
    and W4 split-rope + int4-cache small models (the `reference` phase's
    limits); then greedy generate_spec against greedy generate on the card,
    a small fp32 c2i model with CFG and no control features (the reference's
    clamped control rows make a chunk at the block end differ from decode
    steps), drafted by an unrelated model: the same tokens, or a first
    difference at a near-tie (top-2 margin below 1e-4 of max |logit|)."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch import spec_decode as tspec
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt

    errs = {"fp32": _chunk_reference(None, None)}
    check(errs["fp32"][0] <= REF_TOL, "spec_reference",
          f"fp32: card vs CPU max_abs_err {errs['fp32'][0]} > {REF_TOL}")
    for name, mode, cache in (("w8_kv8", "int8", torch.int8), ("w4split_kv4", "w4", "int4")):
        err, scale = errs[name] = _chunk_reference(mode, cache)
        check(err <= QUANT_REF_TOL[name] * scale, "spec_reference",
              f"{name}: card vs CPU max_abs_err {err} > {QUANT_REF_TOL[name]} * {scale}")

    cfg = GPTConfig(model_type="c2i", dim=256, n_layer=3, n_head=4, vocab_size=256,
                    num_classes=10, block_size=64)
    model = tgpt.init_gpt(cfg, seed=3, device="cuda")
    draft = tgpt.init_gpt(cfg, seed=4, device="cuda")
    labels = torch.arange(4, device="cuda")
    kw = dict(labels=labels, max_new_tokens=cfg.block_size, cfg_scale=4.0, device="cuda")
    spec, stats = tspec.generate_spec(model, cfg, draft, k_draft=4, return_stats=True, **kw)
    plain = tgen.generate(model, cfg, sample_logits=False, **kw)
    diff = (spec != plain).any(0).nonzero()
    margin = None
    if len(diff):
        i = int(diff[0])
        margin, top = _greedy_margin(model, cfg, labels, plain, i, 4.0)
        print(f"spec_reference: first token difference at {i}, top-2 margin {margin}, "
              f"max |logit| {top}", flush=True)
        check(margin < 1e-4 * top, "spec_reference",
              f"greedy spec tokens differ at {i} with a top-2 margin of {margin}")
    check(1.0 <= stats["accepted_per_cycle"] <= 4, "spec_reference", f"stats {stats}")
    emit("spec_reference", ok=True, max_abs_err={k: v[0] for k, v in errs.items()},
         logit_scale={k: v[1] for k, v in errs.items()}, tol_fp32_abs=REF_TOL,
         tol_quantized_relative=QUANT_REF_TOL, greedy_tokens_equal=not len(diff),
         first_difference_margin=margin, greedy_stats=stats)


# Training card vs CPU (fp32 compute; the attention rounds q, k, v, p and ds
# to bf16 on both): the loss to 1e-4 relative, every gradient element to
# 1e-2 of its tensor's max (a different order of fp32 sums can flip one bf16
# rounding of a p or ds, 2**-8 of that term), or of 1e-4 of the largest
# gradient where the tensor's is smaller: a gradient that is zero by
# symmetry (the adapter's key bias: softmax ignores a constant added to a
# row) holds only rounding noise, ~1e-14; after the steps every parameter
# within 2 lr a step (Adam's normalised update of a small gradient whose
# sign flipped). A wrong gradient moves the loss and the norms far more.
TRAIN_REF_LR = 1e-4
TRAIN_REF_TOL = dict(loss=1e-4, grad=1e-2)
TRAIN_REF_STEPS = 2


def _small_control(kind: str):
    """A small control-training setup: (gpt config, adapter config, host
    batch), 128 px (64 tokens), 3 layers of 2 x 64 heads, dropout 0,
    left-padded captions for t2i."""
    from controlar_tpu_torch.cells import train_batch
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import vit as tvit

    cfg = GPTConfig(model_type=kind, dim=128, n_layer=3, n_head=2, vocab_size=64,
                    num_classes=10, caption_dim=32, block_size=64,
                    cls_token_num=8 if kind == "t2i" else 1, token_dropout_p=0.0,
                    resid_dropout_p=0.0, ffn_dropout_p=0.0, class_dropout_prob=0.0)
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=6, pos_grid=8)
    batch = train_batch(cfg, 3, 128, seed=21)
    if kind == "c2i":
        batch["labels"] = np.array([1, 5, 9], np.int32)
    else:  # captions of 2, 5 and all 8 columns
        batch["emb_mask"] = (np.arange(8)[None, :] >= np.array([6, 3, 0])[:, None]).astype(np.int32)
    return cfg, acfg, batch


def _control_model(cfg, acfg):
    """The small setup's ControlModel on the CPU, from seeds; gradients on
    for every parameter but the frozen ones."""
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.train.control_step import ControlModel
    from controlar_tpu_torch.train.optimizer import frozen_mask

    model = ControlModel(tgpt.init_gpt(cfg, seed=3), tvit.init_vit(acfg, seed=4))
    with torch.no_grad():  # the t2i head is zero at init, which zeroes every other gradient
        model.gpt.output.weight.normal_(0.0, 0.02, generator=torch.Generator().manual_seed(5))
    frozen = frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen[n])
    return model


def _loss_and_grads(model, cfg, acfg, batch, remat, condition_type="canny", frozen=None):
    """The control step's fp32 loss and gradients (no update)."""
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train.control_step import make_control_train_step

    fn = make_control_train_step(cfg, acfg, topt.make_optimizer(lr=TRAIN_REF_LR),
                                 condition_type, frozen=frozen, compute_dtype=torch.float32,
                                 remat_policy=remat)
    params = {n: p for n, p in model.named_parameters() if p.requires_grad}
    loss = fn.loss_fn(model, batch, (0, 0))
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _fwd_per_layer(remat: str) -> int:
    """Forward kernel launches per layer and step: twice where the layer is
    recomputed and (out, lse) are not saved."""
    return 1 if remat in ("attn", "qkv_attn", "none") else 2


def _control_pair(kind: str):
    """The small setup of `kind` as (gpt config, adapter config, models,
    batches), each keyed "cpu" and "cuda", the same weights on both."""
    cfg, acfg, host = _small_control(kind)
    cpu_model = _control_model(cfg, acfg)
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to("cuda")}
    batches = {d: {k: torch.from_numpy(v).to(d) for k, v in host.items()} for d in models}
    return cfg, acfg, models, batches


def phase_train_reference():
    """Small t2i and c2i control models: the loss and gradients under all six
    remat policies on the card (each equal to "none" bit for bit, forward
    launches exact), then TRAIN_REF_STEPS control train steps on the card
    (kernels) and on the CPU (plain versions) from the same weights: loss,
    first-step gradients and parameters after the steps; then the same card
    against CPU comparison of c2i steps whose condition is a frozen small HED
    and lineart network."""
    from controlar_tpu_torch.ops import flash_train as ft
    from controlar_tpu_torch.remat import REMAT_POLICIES

    report = {}
    for kind in ("t2i", "c2i"):
        cfg, acfg, models, batches = _control_pair(kind)
        # the six remat policies on the card, with cuDNN's deterministic
        # algorithms: its default weight-gradient algorithm for the adapter's
        # patch projection differs from run to run by ~1e-12
        grads, launches = {}, {}
        torch.backends.cudnn.deterministic = True
        for remat in REMAT_POLICIES:
            for f in (ft.flash_train_fwd, ft.flash_train_dq, ft.flash_train_dkv):
                f.launches = 0
            grads[remat] = _loss_and_grads(models["cuda"], cfg, acfg, batches["cuda"], remat)
            torch.cuda.synchronize()
            launches[remat] = [ft.flash_train_fwd.launches, ft.flash_train_dq.launches,
                               ft.flash_train_dkv.launches]
            want = [cfg.n_layer * _fwd_per_layer(remat), cfg.n_layer, cfg.n_layer]
            check(launches[remat] == want, "train_reference",
                  f"{kind} {remat}: launches fwd/dq/dkv {launches[remat]} != {want}")
        torch.backends.cudnn.deterministic = False
        base_loss, base_grads = grads["none"]
        identical = {r: bool(torch.equal(l, base_loss)
                             and all(torch.equal(g, base_grads[n]) for n, g in gs.items()))
                     for r, (l, gs) in grads.items()}
        check(all(identical.values()), "train_reference",
              f"{kind}: remat policies differ from 'none': {identical}")
        report[kind] = dict(**_train_card_vs_cpu(kind, cfg, acfg, models, batches,
                                                 (base_loss, base_grads)),
                            remat_bit_identical=identical, launches_fwd_dq_dkv=launches)
    # the frozen condition networks: small HED and lineart, c2i
    for ct in ("hed", "lineart"):
        cfg, acfg, models, batches = _control_pair("c2i")
        net = _small_condition_nets()[ct]
        frozen = {"cpu": {ct: net}, "cuda": {ct: copy.deepcopy(net).to("cuda")}}
        report[ct] = _train_card_vs_cpu(ct, cfg, acfg, models, batches, None, ct, frozen)
    emit("train_reference", ok=True, lr=TRAIN_REF_LR, steps=TRAIN_REF_STEPS,
         tol=TRAIN_REF_TOL, param_tol=2 * TRAIN_REF_LR * TRAIN_REF_STEPS, **report)


def _train_card_vs_cpu(label, cfg, acfg, models, batches, card_loss_grads,
                       condition_type="canny", frozen=None) -> dict:
    """First-step loss and gradients, then TRAIN_REF_STEPS control train steps,
    on the card (kernels) and on the CPU (plain versions) from the same
    weights. card_loss_grads: the card's first-step (loss, grads) under
    remat "none" when already computed."""
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import step as tstep
    from controlar_tpu_torch.train.control_step import make_control_train_step

    frozen = frozen or {"cpu": None, "cuda": None}
    base_loss, base_grads = card_loss_grads or _loss_and_grads(
        models["cuda"], cfg, acfg, batches["cuda"], "full", condition_type, frozen["cuda"])
    cpu_loss, cpu_grads = _loss_and_grads(models["cpu"], cfg, acfg, batches["cpu"], "full",
                                          condition_type, frozen["cpu"])
    loss_err = abs(base_loss.item() - cpu_loss.item()) / abs(cpu_loss.item())
    floor = 1e-4 * max(g.abs().max().item() for g in cpu_grads.values())
    grad_errs = {n: (base_grads[n].cpu() - g).abs().max().item()
                 / max(g.abs().max().item(), floor) for n, g in cpu_grads.items()}
    grad_err = max(grad_errs.values())
    worst = sorted(grad_errs, key=grad_errs.get)[-3:]
    check(loss_err <= TRAIN_REF_TOL["loss"] and grad_err <= TRAIN_REF_TOL["grad"],
          "train_reference", f"{label}: loss rel err {loss_err}, grad rel err {grad_err} "
          f"(worst {[(n, grad_errs[n]) for n in worst]})")
    losses, final = {}, {}
    for dev, model in models.items():
        tx = topt.make_optimizer(lr=TRAIN_REF_LR)
        fn = make_control_train_step(cfg, acfg, tx, condition_type, frozen=frozen[dev],
                                     compute_dtype=torch.float32)
        state = tstep.init_train_state(model, tx)
        losses[dev] = []
        for _ in range(TRAIN_REF_STEPS):
            state, m = fn(model, state, batches[dev], 0)
            losses[dev].append(m["loss"].item())
        final[dev] = {n: p.detach().cpu() for n, p in model.named_parameters()}
    param_err = max((final["cuda"][n] - p).abs().max().item() for n, p in final["cpu"].items())
    step_loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"]))
    check(step_loss_err <= TRAIN_REF_TOL["loss"]
          and param_err <= 2 * TRAIN_REF_LR * TRAIN_REF_STEPS, "train_reference",
          f"{label}: step loss rel err {step_loss_err}, param max abs err {param_err}")
    return dict(loss_rel_err=loss_err, grad_rel_err=grad_err, step_losses=losses,
                step_loss_rel_err=step_loss_err, param_max_abs_err=param_err)


# Condition networks card vs CPU, relative to the output's largest
# magnitude. Both sides run the same module code, so what this tells apart
# is the card's arithmetic: fp32 with TF32 off sums in another order and
# read 2.4e-7 to 4.3e-6 on an H100; the same calls with TF32 on read
# 2.7e-4 (lineart) to 2.9e-3 (DPT), printed as tf32_rel_err each run.
COND_REF_TOL = 1e-4
COND_BATCH, COND_PX, COND_TIMED = 8, 512, 3


def _small_condition_nets():
    """Small HED (channels 8..32), lineart (ngf 8), DPT (width 64, 4 layers)
    and MiDaS (trunk layers (1, 1, 1), a 3-layer ViT of width 64) on the CPU,
    random weights from seeds, with their configurations."""
    from controlar_tpu_torch.models import control_nets as cn
    from controlar_tpu_torch.models import dpt as tdpt
    from controlar_tpu_torch.models import midas as tmidas

    dcfg = tdpt.DPTConfig(hidden_size=64, n_layer=4, n_head=2, mlp_dim=128, pos_grid=4,
                          out_indices=(0, 1, 2, 3), neck_hidden_sizes=(16, 32, 64, 64),
                          fusion_hidden_size=32)
    mcfg = tmidas.MidasHybridConfig(stem_width=32, layers=(1, 1, 1), hidden_size=64,
                                    n_layer=3, n_head=2, mlp_dim=128, pos_grid=4,
                                    vit_hooks=(1, 2), features=32,
                                    layer_channels=(256, 512, 64, 64))
    return {"hed": cn.init_hed(seed=1, device="cpu", channels=(8, 16, 32, 32, 32)),
            "lineart": cn.init_lineart(seed=2, device="cpu", ngf=8),
            "dpt": tdpt.init_dpt(dcfg, seed=3, device="cpu"), "dpt_cfg": dcfg,
            "midas": tmidas.init_midas(mcfg, seed=4, device="cpu"), "midas_cfg": mcfg}


def _condition_call(name: str, nets: dict):
    """-> f(uint8 images (B, H, W, 3) on a device) -> the pipeline's 0..255
    condition map, through `control_nets.condition_map` with the network `name`
    of `nets` (DPT and MiDaS as the depth control)."""
    from controlar_tpu_torch.models.control_nets import condition_map

    if name in ("hed", "lineart"):
        return lambda x: condition_map(name, x, **{name: nets[name]})
    return lambda x: condition_map("depth", x, **{name: nets[name],
                                                  f"{name}_cfg": nets[f"{name}_cfg"]})


@contextlib.contextmanager
def _tf32(on: bool):
    """TF32 for cuDNN convolutions and cuBLAS matmuls set to `on` inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def phase_condition_reference():
    """The small condition networks on the card against the same modules on
    the CPU (the path the tests hold to the JAX package), fp32 with TF32
    off, through the pipeline's condition maps: HED and lineart on 64 x 96
    images, DPT on them resized to 96 x 96 (a resized position grid), MiDaS
    at 64 x 96 (its own size, a rectangular grid); the raw MiDaS and DPT
    depth too; then hed_nms on the HED map, bit for bit."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.models import control_nets as cn
    from controlar_tpu_torch.models import dpt as tdpt
    from controlar_tpu_torch.models import midas as tmidas

    img = torch.from_numpy(condition_images(2, 96, seed=9)[:, :64])
    nets = {"cpu": _small_condition_nets()}
    nets["cuda"] = {k: (copy.deepcopy(v).to("cuda") if isinstance(v, torch.nn.Module) else v)
                    for k, v in nets["cpu"].items()}
    dcfg, mcfg = nets["cpu"]["dpt_cfg"], nets["cpu"]["midas_cfg"]
    calls = {name: {d: _condition_call(name, nets[d]) for d in nets}
             for name in ("hed", "lineart", "dpt", "midas")}
    calls["dpt_depth"] = {d: (lambda x, d=d: tdpt.dpt_depth(
        nets[d]["dpt"], dcfg, tdpt.preprocess_depth_input(x, 96))) for d in nets}
    calls["midas_depth"] = {d: (lambda x, d=d: tmidas.midas_hybrid_depth(
        nets[d]["midas"], mcfg, x.float() / 127.5 - 1.0)) for d in nets}
    errs, tf32_errs = {}, {}
    with torch.inference_mode():
        for name, fns in calls.items():
            ref = fns["cpu"](img)
            out = fns["cuda"](img.cuda()).cpu()
            check(out.shape == ref.shape and bool(torch.isfinite(out).all()),
                  "condition_reference", f"{name}: shape {tuple(out.shape)} or non-finite")
            errs[name] = (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-12)
            # the same call with TF32 on: what the limit must tell apart
            with _tf32(True):
                out = fns["cuda"](img.cuda()).cpu()
            tf32_errs[name] = (out - ref).abs().max().item() / max(ref.abs().max().item(), 1e-12)
            if name == "hed":
                hed_map = ref
    for name, err in errs.items():
        check(err <= COND_REF_TOL, "condition_reference",
              f"{name}: card vs CPU max_abs_err / max|ref| {err} > {COND_REF_TOL}")
    # hed_nms of one map on both devices: the same uint8 map
    nms_cpu = cn.hed_nms(hed_map, 64.0, 2.0)
    nms_cuda = cn.hed_nms(hed_map.cuda(), 64.0, 2.0).cpu()
    check(torch.equal(nms_cuda, nms_cpu) and 0 < float((nms_cuda == 255).float().mean()) < 1,
          "condition_reference", "hed_nms differs between card and CPU (or is constant)")
    emit("condition_reference", ok=True, rel_err=errs, tf32_rel_err=tf32_errs, tol=COND_REF_TOL,
         hed_nms_bit_exact=True,
         hed_nms_edge_share=float((nms_cuda == 255).float().mean()), image=[2, 64, 96],
         dpt_input=[96, 96])


def phase_condition() -> dict:
    """Each condition network at full width through the pipeline's condition
    maps, batch COND_BATCH at COND_PX px, random weights from seeds, fp32,
    TF32 off: HED and lineart at the annotators' widths, DPT at DPT_LARGE
    (ViT-L/16 on a 32 x 32 grid, resized positions), MiDaS at MIDAS_HYBRID at
    the image's own size. A warm call, then COND_TIMED synchronised calls
    (host clock); ms is their median. Peak memory over the timed calls."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.models import control_nets as cn
    from controlar_tpu_torch.models import dpt as tdpt
    from controlar_tpu_torch.models import midas as tmidas

    x = torch.from_numpy(condition_images(COND_BATCH, COND_PX, seed=11)).cuda()
    builders = {
        "hed": lambda: {"hed": cn.init_hed(seed=21)},
        "lineart": lambda: {"lineart": cn.init_lineart(seed=22)},
        "dpt": lambda: {"dpt": tdpt.init_dpt(tdpt.DPT_LARGE, seed=23), "dpt_cfg": tdpt.DPT_LARGE},
        "midas": lambda: {"midas": tmidas.init_midas(tmidas.MIDAS_HYBRID, seed=24),
                          "midas_cfg": tmidas.MIDAS_HYBRID},
    }
    rows = {}
    for name, build in builders.items():
        nets = build()
        call = _condition_call(name, nets)
        with torch.inference_mode():
            call(x)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            seconds = []
            for _ in range(COND_TIMED):
                t0 = time.perf_counter()
                out = call(x)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
        check(out.shape == (COND_BATCH, COND_PX, COND_PX) and bool(torch.isfinite(out).all())
              and float(out.min()) >= 0 and float(out.max()) <= 255 + 1e-3
              and float(out.std()) > 0, "condition", f"{name}: output {tuple(out.shape)} "
              f"range [{float(out.min())}, {float(out.max())}]")
        rows[name] = dict(ms=statistics.median(seconds) * 1e3,
                          seconds=seconds, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                          params_m=sum(p.numel() for p in nets[name].parameters()) / 1e6)
        del nets, call, out
        torch.cuda.empty_cache()
    emit("condition", ok=True, batch=COND_BATCH, image_px=COND_PX, dtype="float32", tf32=False,
         timed_calls=COND_TIMED, **rows)
    return rows


# The checkpoint phase: full-width models made from seeds, written in the
# reference layouts and read back through the loaders.
CKPT_SEEDS = {"gpt": 0, "vq": 1, "adapter": 2}
CKPT_VQ_PX, CKPT_VQ_BATCH = 128, 2
CKPT_TIE_GAP = 1e-5   # fp32 distances |z|^2 + |e|^2 - 2 z.e of unit vectors: a tie
CKPT_GREEDY_TOKENS = 16


def _ckpt_models(dtype, device):
    """The c2i cell's GPT-B (576 tokens), the VQ-16 with its encoder and
    DINOv2-small, from CKPT_SEEDS."""
    from controlar_tpu_torch.config import gpt_config, vq_config
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.models import vq as tvq

    cfg = gpt_config("GPT-B", model_type="c2i", cls_token_num=1, block_size=576,
                     vocab_size=16384, num_classes=1000)
    vcfg = vq_config("VQ-16")
    return cfg, vcfg, {
        "gpt": tgpt.init_gpt(cfg, seed=CKPT_SEEDS["gpt"], dtype=dtype, device=device),
        "vq": tvq.init_vq(vcfg, seed=CKPT_SEEDS["vq"], device=device),
        "adapter": tvit.init_vit(tvit.DINOV2_SMALL, seed=CKPT_SEEDS["adapter"], device=device)}


def _tie_gaps(h: torch.Tensor, emb: torch.Tensor, got: torch.Tensor, want: torch.Tensor):
    """Where two index grids differ: |d(h, e_got) - d(h, e_want)| per position,
    d the fp32 distance of the normalised latent h (..., D) to a code of emb."""
    differ = got != want
    if not differ.any():
        return []
    zn = torch.nn.functional.normalize(h[differ].float(), dim=-1)
    d = (zn * zn).sum(-1, keepdim=True) + (emb * emb).sum(-1) - 2 * zn @ emb.T
    rows = torch.arange(len(zn), device=zn.device)
    return (d[rows, got[differ].long()] - d[rows, want[differ].long()]).abs().tolist()


def _vq_card_vs_cpu(vq_card, vq_cpu, vcfg) -> dict:
    """encode then decode_code on the card against the same model on the CPU
    (fp32): latents, quantized z and images within REF_TOL, code indices
    equal or ties (their two codes' distances within CKPT_TIE_GAP)."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.models import vq as tvq

    x = torch.from_numpy(condition_images(CKPT_VQ_BATCH, CKPT_VQ_PX, seed=13)).float() / 127.5 - 1
    out = {}
    with torch.inference_mode():
        for dev, vq in (("cuda", vq_card), ("cpu", vq_cpu)):
            h = tvq._conv(vq.quant_conv, tvq.encoder_forward(vq.encoder, vcfg, x.to(dev)))
            z_q, idx = tvq.encode(vq, vcfg, x.to(dev), device=dev)
            out[dev] = dict(h=h.cpu(), z_q=z_q.cpu(), idx=idx.cpu())
        cpu, card = out["cpu"], out["cuda"]
        h_err = (card["h"] - cpu["h"]).abs().max().item()
        h_scale = max(cpu["h"].abs().max().item(), 1.0)
        differ = card["idx"] != cpu["idx"]
        gaps = _tie_gaps(cpu["h"], tvq._codebook(vq_cpu, vcfg), card["idx"], cpu["idx"])
        same = ~differ
        zq_err = (card["z_q"][same] - cpu["z_q"][same]).abs().max().item()
        img_card = tvq.decode_code(vq_card, vcfg, cpu["idx"].cuda()).cpu()
        img_cpu = tvq.decode_code(vq_cpu, vcfg, cpu["idx"])
    img_err = (img_card - img_cpu).abs().max().item()
    check(h_err <= REF_TOL * h_scale and zq_err <= REF_TOL and img_err <= REF_TOL
          and all(g <= CKPT_TIE_GAP for g in gaps), "checkpoint",
          f"VQ card vs CPU: latents {h_err} (scale {h_scale}), z_q {zq_err}, image {img_err}, "
          f"index gaps {gaps}")
    return dict(vq_encode_latent_max_abs_err=h_err, vq_latent_scale=h_scale,
                vq_z_q_max_abs_err=zq_err, vq_image_max_abs_err=img_err,
                vq_codes=int(differ.numel()), vq_index_ties=len(gaps),
                vq_tie_gaps=gaps, vq_image_shape=list(img_card.shape))


def phase_checkpoint() -> collections.Counter:
    """Full-width GPT-B c2i, VQ-16 (encoder included) and DINOv2-small from
    seeds, fp32 on the card, written in the reference layouts (`convert_ref`:
    {"model": sd, "args": Namespace} .pt, and .safetensors in fp32 and bf16)
    to a temporary directory, then read with `checkpoint.load_gpt_checkpoint`,
    `load_vq_checkpoint` and `load_adapter_checkpoint` onto the card in the
    file's dtype: each parameter bit for bit its source. Then the loaded VQ's
    encode and decode_code against the same model on the CPU, and a c2i
    `ControlARPipeline` of the loaded bf16 GPT, VQ and adapter against one
    built from the seeds: greedy first CKPT_GREEDY_TOKENS tokens (CFG 4.0)
    of the pipeline's control features, equal. Returns the launches of the
    greedy calls."""
    import argparse
    import tempfile

    from controlar_tpu_torch import checkpoint as ck
    from controlar_tpu_torch import convert_ref as cr
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.cells import BATCH, condition_images
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.pipeline import ControlARPipeline

    t_phase = time.perf_counter()
    cfg, vcfg, src = _ckpt_models(torch.float32, "cuda")
    acfg = tvit.DINOV2_SMALL
    layouts = {"gpt": cr.gpt_reference_state_dict(src["gpt"]),
               "vq": cr.vq_reference_state_dict(src["vq"]),
               "adapter": cr.vit_hf_state_dict(src["adapter"], acfg)}
    # keys of a ControlAR checkpoint that the GPT loader skips
    layouts["gpt"]["condition_embeddings.weight"] = torch.zeros(8, 8)
    loaders = {"gpt": lambda p, dt: ck.load_gpt_checkpoint(p, cfg, dt, "cuda"),
               "vq": lambda p, dt: ck.load_vq_checkpoint(p, vcfg, dt, "cuda"),
               "adapter": lambda p, dt: ck.load_adapter_checkpoint(p, acfg, "dinov2", dt,
                                                                   "cuda")}
    files, loaded = {}, {}
    with tempfile.TemporaryDirectory(prefix="controlar_ckpt_") as tmp:
        for name, sd in layouts.items():
            sd = {k: v.cpu() for k, v in sd.items()}
            paths = {"pt": (f"{tmp}/{name}.pt", torch.float32),
                     "st_fp32": (f"{tmp}/{name}_fp32.safetensors", torch.float32),
                     "st_bf16": (f"{tmp}/{name}_bf16.safetensors", torch.bfloat16)}
            torch.save({"model": sd, "args": argparse.Namespace(model=name, seed=0)},
                       paths["pt"][0])
            ck.save_safetensors(sd, paths["st_fp32"][0])
            ck.save_safetensors({k: v.to(torch.bfloat16) if v.is_floating_point() else v
                                 for k, v in sd.items()}, paths["st_bf16"][0])
            del sd
            for kind, (path, dtype) in paths.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model = loaders[name](path, dtype)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                want = src[name].state_dict()
                got = model.state_dict()
                check(set(got) == set(want) and all(
                    got[k].dtype == dtype and torch.equal(got[k], want[k].to(dtype))
                    for k in want), "checkpoint", f"{name} {kind}: loaded parameters differ "
                      "from their source")
                gb = Path(path).stat().st_size / 1e9
                files[f"{name}_{kind}"] = dict(load_ms=ms, gb=gb, gb_per_s=gb / ms * 1e3)
                if kind == "st_bf16" and name == "gpt" or kind == "pt" and name != "gpt":
                    loaded[name] = model
                del model
    vq_cpu = src["vq"].cpu()
    rows = _vq_card_vs_cpu(loaded["vq"], vq_cpu, vcfg)
    del src, vq_cpu

    seeded = _ckpt_models(torch.bfloat16, "cuda")[2]
    images = condition_images(BATCH, 384, seed=7)
    labels = np.arange(BATCH) * 100
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    tokens = {}
    for label, mods in (("loaded", loaded), ("seeded", seeded)):
        pipe = ControlARPipeline(gpt_cfg=cfg, gpt=mods["gpt"], vq_cfg=vcfg, vq=mods["vq"],
                                 adapter_cfg=acfg, adapter=mods["adapter"], device="cuda")
        feats = pipe.control_features(pipe.extract_condition(images))
        tokens[label] = tgen.generate(pipe.gpt, cfg, labels=labels, adapter_features=feats,
                                      max_new_tokens=CKPT_GREEDY_TOKENS, cfg_scale=4.0,
                                      sample_logits=False, device="cuda").cpu()
    launches = collections.Counter({k: fn.launches for k, fn in wrappers.items()})
    check(torch.equal(tokens["loaded"], tokens["seeded"]), "checkpoint",
          f"greedy tokens of the loaded pipeline {tokens['loaded'][:, :8].tolist()} differ from "
          f"the seeded one's {tokens['seeded'][:, :8].tolist()}")
    want = {"flash_decode_attention": 2 * cfg.n_layer * (CKPT_GREEDY_TOKENS - 1),
            "append_kv": 2 * cfg.n_layer * (CKPT_GREEDY_TOKENS - 1)}
    for k, got in launches.items():
        check(got == want.get(k, 0), "checkpoint", f"{k} launches {got} != {want.get(k, 0)}")
    del loaded, seeded
    torch.cuda.empty_cache()
    emit("checkpoint", ok=True, seconds=time.perf_counter() - t_phase, model="GPT-B c2i 384 px",
         vq="VQ-16 (encoder included)", adapter="DINOv2-small", files=files,
         bit_exact=True, **rows, greedy_tokens=CKPT_GREEDY_TOKENS,
         greedy_first_row=tokens["loaded"][0].tolist(),
         launches={k: v for k, v in launches.items() if v})
    return launches


# The quality phase: GPT-B c2i toy-trained on the card, then the quant report
# and an int8 self-draft on the trained weights.
QUALITY_STEPS, QUALITY_BATCH, QUALITY_BLOCK = 150, 16, 256
QUALITY_TOKENS, QUALITY_ROWS, QUALITY_SPEC_K = 256, 4, 4
QUALITY_LOSS_MAX = 2.0     # init ~9.7, the task's optimum ~1.3
QUALITY_TF_MIN = 0.99      # docs/quant_stress.md's ship threshold, int8 modes
QUALITY_ACCEPT_MIN = 2.0   # random weights accept ~1.0 a cycle
# the decode (rollouts), chunk (teacher forcing) and W4 kernels each part
# of the report must launch; every other attention kernel must not
_QUALITY_KERNELS = {
    "bf16": ("flash_decode_attention", "flash_chunk_attention", "append_kv"),
    "int8": ("flash_decode_attention", "flash_chunk_attention", "append_kv"),
    "int8+kv8": ("flash_decode_attention_q8", "flash_chunk_attention_q8", "append_kv"),
    "w4": ("flash_decode_attention", "flash_chunk_attention", "append_kv", "w4_matmul",
           "w4_ffn"),
    "w4+kv8": ("flash_decode_attention_q8", "flash_chunk_attention_q8", "append_kv",
               "w4_matmul", "w4_ffn"),
    "w4+kv4": ("flash_decode_attention_q4", "flash_chunk_attention_q4", "append_kv",
               "w4_matmul", "w4_ffn"),
    "spec": ("flash_decode_attention", "flash_chunk_attention", "append_kv"),
}


def phase_quality() -> collections.Counter:
    """`toy_train.train` on the basic task (GPT-B c2i, block QUALITY_BLOCK,
    batch QUALITY_BATCH, AdamW, the training kernels; launches exact), the
    last logged loss under QUALITY_LOSS_MAX; then on the bf16 model
    `measure_quant_agreement` in the five modes (QUALITY_TOKENS tokens,
    QUALITY_ROWS rows), int8 and int8+kv8 gated at teacher-forced agreement
    >= QUALITY_TF_MIN (W4 printed), each part's kernels launched and no
    other attention kernel; then greedy speculative decode with an int8 copy
    as the draft (k = QUALITY_SPEC_K), accepted tokens a cycle above
    QUALITY_ACCEPT_MIN. Returns the launches."""
    from controlar_tpu_torch import toy_train
    from controlar_tpu_torch.eval.quant_report import MODES, measure_quant_agreement

    t_phase = time.perf_counter()
    cfg = toy_train.toy_config("GPT-B", QUALITY_BLOCK)
    wrappers = {k: v[0] for k, v in _kernels().items()}
    total = collections.Counter()

    def take() -> dict:
        got = {k: fn.launches for k, fn in wrappers.items()}
        for fn in wrappers.values():
            fn.launches = 0
        total.update(got)
        return got

    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = toy_train.train(cfg, steps=QUALITY_STEPS, batch=QUALITY_BATCH, device="cuda",
                          log=lambda msg: None)
    train_s = time.perf_counter() - t0
    got = take()
    per_step = {"flash_train_fwd": cfg.n_layer * _fwd_per_layer("full"),
                "flash_train_dq": cfg.n_layer, "flash_train_dkv": cfg.n_layer}
    for k, n in got.items():
        check(n == QUALITY_STEPS * per_step.get(k, 0), "quality",
              f"training: {k} launches {n} != {QUALITY_STEPS * per_step.get(k, 0)}")
    losses = res["losses"]
    check(bool(np.isfinite(losses).all()) and losses[-1] < QUALITY_LOSS_MAX, "quality",
          f"toy training did not converge: losses {losses}")
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms_per_step = res["ms_per_step"]
    model = res["model"].to(torch.bfloat16)
    del res
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    by_part = {}
    rep = measure_quant_agreement(model, cfg, modes=MODES, max_new_tokens=QUALITY_TOKENS,
                                  labels=np.arange(QUALITY_ROWS) % 16, device="cuda",
                                  on_mode=lambda m: by_part.__setitem__(m, take()))
    report_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = toy_train.spec_acceptance(model, cfg, QUALITY_SPEC_K, QUALITY_TOKENS,
                                     torch.arange(QUALITY_ROWS, device="cuda") % 16, "cuda")
    spec_s = time.perf_counter() - t0
    by_part["spec"] = take()
    attention = [k for k in wrappers if k.startswith(("flash_decode_attention",
                                                      "flash_chunk_attention"))]
    for part, need in _QUALITY_KERNELS.items():
        got = by_part[part]
        for k in need:
            check(got[k] > 0, "quality", f"{part}: {k} was not launched ({got})")
        for k in attention:
            check(k in need or got[k] == 0, "quality", f"{part}: {k} launched {got[k]} times")
    for mode in ("int8", "int8+kv8"):
        tf = rep[mode]["teacher_forced_agreement"]
        check(tf >= QUALITY_TF_MIN, "quality",
              f"{mode}: teacher-forced agreement {tf} < {QUALITY_TF_MIN}")
    check(spec["accepted_per_cycle"] > QUALITY_ACCEPT_MIN, "quality",
          f"int8 self-draft accepted {spec['accepted_per_cycle']} a cycle")
    del model
    torch.cuda.empty_cache()
    emit("quality", ok=True, seconds=time.perf_counter() - t_phase, model="GPT-B c2i",
         task="basic", block_size=QUALITY_BLOCK, batch=QUALITY_BATCH, steps=QUALITY_STEPS,
         optimizer="adamw", train_s=train_s, ms_per_step=ms_per_step, losses=losses,
         train_peak_mem_gb=train_peak, report_tokens=QUALITY_TOKENS, report_rows=QUALITY_ROWS,
         report_s=report_s, quant_report=rep, spec_k=QUALITY_SPEC_K, spec_s=spec_s,
         spec=spec, launches_by_part={p: {k: v for k, v in d.items() if v}
                                      for p, d in by_part.items()})
    return total


def _palm_flops(trainer) -> float:
    """Model FLOPs of one step by scripts/bench_train.py's PaLM convention:
    B * sum over the GPT and the adapter of 6 N T + 12 L T^2 d, N the
    matmul parameters (two or more dimensions in the JAX package's stacked
    layout), T the sequence each runs (the adapter's patch tokens plus CLS);
    recomputation not counted."""
    from controlar_tpu_torch.train.optimizer import _PER_LAYER

    def matmul_params(module):
        return sum(p.numel() for n, p in module.named_parameters()
                   if p.dim() + bool(_PER_LAYER.search(n)) >= 2)

    g, a, tcfg = trainer.gpt_cfg, trainer.adapter_cfg, trainer.cfg
    t_gpt = g.cls_token_num + g.block_size - 1
    side = tcfg.image_size // 16 * 14  # to_patch14
    t_ad = (side // a.patch_size) ** 2 + 1
    f_gpt = 6 * matmul_params(trainer.model.gpt) * t_gpt + 12 * g.n_layer * t_gpt ** 2 * g.dim
    f_ad = (6 * matmul_params(trainer.model.adapter) * t_ad
            + 12 * a.n_layer * t_ad ** 2 * a.hidden_size)
    return tcfg.global_batch_size * (f_gpt + f_ad), t_gpt, t_ad


def phase_train_cell(name: str, warm: int = 2, timed: int = 5) -> dict:
    """`Trainer.fit` on the cell's fixed batch: `warm` steps, then `timed`
    steps with every kernel's launch count set to 0 just before them (each
    count must be exact), each step timed on the host clock around the
    synchronised step (the trainer logs every step, reading its loss).
    Reports ms per step, img/s, model TFLOP and MFU against the H100's
    dense bf16 peak, peak memory and the loss at the first and last step
    (finite, and lower at the end). Returns the launches."""
    from controlar_tpu_torch.cells import FixedBatchLoader, build_train_cell

    t0 = time.perf_counter()
    trainer, batch = build_train_cell(name, log_every=1, ckpt_every=10 ** 9)
    state = trainer.fit(FixedBatchLoader(batch, warm), max_steps=warm)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    state = trainer.fit(FixedBatchLoader(batch, timed), state, max_steps=warm + timed)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    cfg, tcfg = trainer.gpt_cfg, trainer.cfg
    per_step = {"flash_train_fwd": cfg.n_layer * _fwd_per_layer(tcfg.remat_policy),
                "flash_train_dq": cfg.n_layer, "flash_train_dkv": cfg.n_layer}
    for k, got in launches.items():
        check(got == timed * per_step.get(k, 0), name,
              f"{k} launches {got} != {timed * per_step.get(k, 0)}")
    hist = trainer.history
    seconds = [r["seconds"] for r in hist if r["step"] > warm]
    check(len(seconds) == timed and all(r.get("steps", 1) == 1 for r in hist), name,
          f"step records {hist}")
    losses = [r["loss"] for r in hist]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], name,
          f"losses {losses}: not finite, or not lower at the end")
    ms = statistics.median(seconds) * 1e3
    flops, t_gpt, t_ad = _palm_flops(trainer)
    emit(name, ok=True, model=tcfg.gpt_model, model_type=tcfg.model_type,
         image_px=tcfg.image_size, t_gpt=t_gpt, t_adapter=t_ad,
         batch=tcfg.global_batch_size, remat=tcfg.remat_policy,
         opt_state_dtype=tcfg.opt_state_dtype, dropout=tcfg.dropout_p,
         warm_steps=warm, warm_s=warm_s, timed_steps=timed, step_seconds=seconds,
         ms_per_step=ms, images_per_s=tcfg.global_batch_size / (ms / 1e3),
         model_tflop_per_step=flops / 1e12,
         mfu=flops / (ms / 1e3) / BF16_FLOPS, mfu_peak="989 TFLOP/s dense bf16 (H100 SXM)",
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
         loss_first=losses[0], loss_last=losses[-1], losses=losses,
         launches_per_step=per_step, launches={k: v for k, v in launches.items() if v})
    return launches


def _expected_per_call(name: str, cfg) -> dict:
    """Launches of each kernel in one generate call of the cell: attention
    and the fused KV write at every decode step of every layer (the prefill
    writes its rows by assignment); on the W4 path two W4 products
    (wqkv, wo) and one fused FFN per layer at the prefill (16 rows) and at
    every decode step."""
    from controlar_tpu_torch.cells import CELLS

    cell, layers, steps = CELLS[name], cfg.n_layer, cfg.block_size - 1
    write = {"append_kv": layers * steps}
    if cell.get("quant") == "w4":
        return {"flash_decode_attention_q4": layers * steps, **write,
                "w4_matmul": 2 * layers * (steps + 1), "w4_ffn": layers * (steps + 1)}
    if cell.get("cache_dtype") == torch.int8:
        return {"flash_decode_attention_q8": layers * steps, **write}
    return {"flash_decode_attention": layers * steps, **write}


def _warm_cell(pipe, kw) -> None:
    """A short warm call: the pipeline's condition, adapter and VQ decoder at
    the cell's sizes and 16 decode steps of its model with the cell's batch,
    CFG, captions and cache dtype, which runs every kernel and matrix shape
    of a timed call (a full warm call would repeat the timed call's length,
    as the speculative cells' warm calls avoid too)."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.models import vq as tvq

    cfg = pipe.gpt_cfg
    with torch.inference_mode():
        feats = pipe.control_features(pipe.extract_condition(kw["condition_images"]))
        tgen.generate(pipe.gpt, cfg, labels=kw.get("labels"), caption_emb=kw.get("caption_emb"),
                      emb_masks=kw.get("emb_masks"), adapter_features=feats, max_new_tokens=16,
                      cfg_scale=kw["cfg_scale"], top_k=kw["top_k"],
                      cache_dtype=kw["cache_dtype"] or torch.bfloat16, seed=0, device="cuda")
        gh, gw = cfg.grid
        tvq.decode_code(pipe.vq, pipe.vq_cfg, torch.zeros(
            len(kw["condition_images"]), gh, gw, dtype=torch.long, device="cuda"))


def phase_cell(name: str, runs: int) -> dict:
    """A short warm call (`_warm_cell`), then `runs` timed
    `ControlARPipeline.generate` calls with every kernel's launch count set
    to 0 before them; each count must be exactly its expected launches.
    Returns the launches."""
    from controlar_tpu_torch.cells import BATCH, CELLS, build_cell

    t0 = time.perf_counter()
    pipe, kw = build_cell(name, n_layer=CELL_DEPTH.get(name))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg = pipe.gpt_cfg
    px = CELLS[name]["image_px"]
    _warm_cell(pipe, kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, outs = [], []
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    stages = []  # each timed call's stage seconds (the pipeline's `timings`)
    for run in range(runs):
        stages.append({})
        t0 = time.perf_counter()
        outs.append(pipe.generate(**kw, seed=1 + run, timings=stages[-1]))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    per_call = _expected_per_call(name, cfg)
    for k, got in launches.items():
        want = runs * per_call.get(k, 0)
        check(got == want, name, f"{k} launches {got} != {want}")
    for out in outs:
        check(out.shape == (BATCH, px, px, 3) and out.dtype == np.uint8, name,
              f"output {out.shape} {out.dtype}")
        check(float(out.std()) > 0, name, "constant output image")
    # finite: ControlARPipeline.generate raises on a non-finite decoded image
    med = statistics.median(seconds)
    emit(name, ok=True, model=CELLS[name]["size"], quant=CELLS[name].get("quant"),
         layers=cfg.n_layer, condition_type=pipe.condition_type, stage_seconds=stages,
         cache_dtype=str(kw.get("cache_dtype") or torch.bfloat16), image_px=px,
         tokens=cfg.block_size, batch=BATCH, cfg_scale=kw["cfg_scale"], top_k=kw["top_k"],
         runs=runs, build_s=build_s, seconds=seconds, median_s=med, images_per_s=BATCH / med,
         shape=list(outs[0].shape), dtype=str(outs[0].dtype), finite=True,
         launches={k: v for k, v in launches.items() if v},
         launches_per_call=per_call, peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


def _stacked_expected(base: str, cfg) -> dict:
    """Launches of each kernel in one generate(kv_stacked=True) call on the
    model of pipeline cell `base`: the stacked attention in place of the
    flat one, the fused KV write into the in-flight rows at every decode
    step of every layer, one end-of-step write a step, the W4 kernels as in
    the flat call."""
    flat = _expected_per_call(base, cfg)
    attn = next(k for k in flat if k.startswith("flash_decode_attention"))
    suffix = attn.removeprefix("flash_decode_attention")
    out = {f"flash_stacked{suffix}" if k == attn else k: v for k, v in flat.items()}
    return dict(out, append_stacked=cfg.block_size - 1)


def _device_kernels(fn) -> int:
    """Kernels, copies and sets that fn() puts on the card, counted in a
    torch.profiler trace as trace_decode counts them."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = Path("traces") / "chip_smoke_count.json"
    path.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    path.unlink()
    return sum(1 for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


# card vs CPU (and stacked vs per-layer step) limits, relative to max |logit|
STEP_TOL = {torch.bfloat16: REF_TOL, torch.int8: QUANT_REF_TOL["w8_kv8"],
            "int4": QUANT_REF_TOL["w4split_kv4"]}


def _stacked_step_error(model, cfg, kw) -> tuple:
    """The cell's prefill into a per-layer and into a stacked cache, then one
    decode step through each (kernels on) from those same contents ->
    (max abs logit difference, max |logit| of the per-layer step)."""
    from controlar_tpu_torch import decode as tdec
    from controlar_tpu_torch.config import find_multiple
    from controlar_tpu_torch.generate import prepare_inputs

    dev = torch.device("cuda")
    with torch.inference_mode():
        prefix, col_mask, fused3 = prepare_inputs(
            model, cfg, dev, True, labels=kw["labels"], adapter_features=kw["adapter_features"])
        bc, t_cls = prefix.shape[:2]
        s_max = find_multiple(t_cls + cfg.block_size, 256)
        rope = tdec.rope_tables(model, cfg, dev)
        tok = torch.randint(0, cfg.vocab_size, (bc,), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        out = []
        for init in (tdec.init_flat_caches, tdec.init_stacked_caches):
            caches = init(cfg, bc, s_max, kw["cache_dtype"], dev)
            _, caches = tdec.prefill_flat(model, cfg, caches, prefix, fused3, col_mask,
                                          rope_table=rope)
            lg, _ = tdec.decode_step_flat(model, cfg, caches, tok, t_cls, fused3, None,
                                          use_flash=True, rope_table=rope)
            out.append(lg.float())
            del caches
    return (out[0] - out[1]).abs().max().item(), out[0].abs().max().item()


def phase_stacked_cell(name: str) -> dict:
    """`generate.generate` on a pipeline cell's model, with the per-layer
    cache and with the stacked cache (kv_stacked=True), in one process:
    kernels per decode step of each from the profiler (a 17-token call less
    a 9-token call, over 8 steps; these calls also warm both paths), the
    first decode step of each from the same prefill within the cell's
    reference limit, then one timed call of each, flat then stacked, with
    the same seed. Every launch count is set to 0 just before a call and
    must equal its expected launches. Returns the launches."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.cells import BATCH, CELLS, STACKED_CELLS, build_stacked_cell

    t0 = time.perf_counter()
    pipe, kw = build_stacked_cell(name, n_layer=CELL_DEPTH.get(name))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    base, cfg = STACKED_CELLS[name], pipe.gpt_cfg

    def call(stacked, seed, n=cfg.block_size):
        return tgen.generate(pipe.gpt, cfg, kv_stacked=stacked, seed=seed,
                             **dict(kw, max_new_tokens=n))

    modes = {"flat": False, "stacked": True}
    kernels_per_step = {m: (_device_kernels(lambda: call(st, 0, 17))
                            - _device_kernels(lambda: call(st, 0, 9))) / 8
                        for m, st in modes.items()}
    err, scale = _stacked_step_error(pipe.gpt, cfg, kw)
    tol = STEP_TOL[kw["cache_dtype"]]
    check(err <= tol * scale, name, f"first step, stacked vs per-layer: max_abs_err {err} > "
          f"{tol} * {scale}")
    expected = {"flat": _expected_per_call(base, cfg), "stacked": _stacked_expected(base, cfg)}
    wrappers = {k: v[0] for k, v in _kernels().items()}
    seconds, tokens, total = collections.defaultdict(list), {}, collections.Counter()
    torch.cuda.reset_peak_memory_stats()
    for i, mode in enumerate(("flat", "stacked")):
        seed = 1
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        toks = call(modes[mode], seed)
        torch.cuda.synchronize()
        seconds[mode].append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        total.update(launches)
        for k, got in launches.items():
            check(got == expected[mode].get(k, 0), name,
                  f"{mode} run {i}: {k} launches {got} != {expected[mode].get(k, 0)}")
        check(toks.shape == (BATCH, cfg.block_size) and int(toks.min()) >= 0
              and int(toks.max()) < cfg.vocab_size, name,
              f"{mode}: tokens {tuple(toks.shape)} out of shape or range")
        tokens[mode, seed] = toks
    agree = statistics.mean((tokens["flat", sd] == tokens["stacked", sd]).float().mean().item()
                            for sd in {sd for _, sd in tokens})
    steps = cfg.block_size - 1
    emit(name, ok=True, model=CELLS[base]["size"], cell=base, quant=CELLS[base].get("quant"),
         cache_dtype=str(kw["cache_dtype"]), tokens=cfg.block_size, batch=BATCH,
         cfg_scale=kw["cfg_scale"], top_k=kw["top_k"], runs=1, build_s=build_s,
         seconds=dict(seconds),
         median_s={m: statistics.median(v) for m, v in seconds.items()},
         images_per_s={m: BATCH / statistics.median(v) for m, v in seconds.items()},
         kernels_per_step=kernels_per_step,
         port_launches_per_step={m: {k: v / steps for k, v in expected[m].items()}
                                 for m in modes},
         first_step_max_abs_err=err, logit_scale=scale, tol_relative=tol,
         same_seed_token_agreement=agree,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return total


def _spec_expected(name: str, cfg, dcfg, cycles: int) -> dict:
    """Launches of one speculative generate call of `cycles` cycles: each
    cycle runs k draft decode steps (attention and the fused KV write per
    layer) and one verify (chunk attention and the fused KV write per
    layer); on the W4
    target two W4 products (wqkv, wo) and one fused FFN per layer at the
    prefill and at every verify. The prefills launch no attention or append
    kernel."""
    from controlar_tpu_torch.cells import SPEC_CELLS, SPEC_K

    cell = SPEC_CELLS[name]
    cache = cell.get("cache_dtype")
    draft_steps = dcfg.n_layer * SPEC_K * cycles
    verify = cfg.n_layer * cycles
    attn = {None: "", torch.int8: "_q8", "int4": "_q4"}[cache]
    out = {f"flash_decode_attention{attn}": draft_steps,
           f"flash_chunk_attention{attn}": verify,
           "append_kv": draft_steps + verify}
    if cell.get("quant") == "w4":
        out.update(w4_matmul=2 * cfg.n_layer * (cycles + 1), w4_ffn=cfg.n_layer * (cycles + 1))
    return out


def phase_spec_cell(name: str, runs: int) -> dict:
    """A short warm speculative call, then `runs` timed
    `ControlARPipeline.generate` calls (seeds 1, 2, ...) with every kernel's
    launch count set to 0 just before each; each count must equal its
    expected launches for the call's cycles, and accepted_per_cycle lie in
    [1, k]. The warm call decodes 16 tokens on the cell's models, batch, k
    and cache dtype, which runs every kernel and matrix shape of the timed
    calls (the condition, adapter and VQ shapes are warm from the c2i cells;
    a full 576-token warm call would add a minute per cell). Returns the
    launches of the timed calls."""
    from controlar_tpu_torch import spec_decode
    from controlar_tpu_torch.cells import (
        BATCH, SPEC_CELLS, SPEC_DRAFT_SIZE, SPEC_K, build_spec_cell)

    t0 = time.perf_counter()
    pipe, kw = build_spec_cell(name, n_layer=SPEC_DEPTH[0], draft_n_layer=SPEC_DEPTH[1])
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, dcfg = pipe.gpt_cfg, pipe.draft_gpt_cfg
    px = SPEC_CELLS[name]["image_px"]
    with torch.inference_mode():
        feats = pipe.control_features(pipe.extract_condition(kw["condition_images"]))
    spec_decode.generate_spec(pipe.gpt, cfg, pipe.draft_gpt, dcfg, labels=kw["labels"],
                              adapter_features=feats, max_new_tokens=16, k_draft=SPEC_K,
                              cfg_scale=kw["cfg_scale"], top_k=kw["top_k"],
                              cache_dtype=kw["cache_dtype"] or torch.bfloat16, seed=0,
                              device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {k: v[0] for k, v in _kernels().items()}
    seconds, calls, total = [], [], collections.Counter()
    for run in range(runs):
        stats = {}
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = pipe.generate(**kw, seed=1 + run, spec_stats=stats)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        launches = {k: fn.launches for k, fn in wrappers.items()}
        total.update(launches)
        want = _spec_expected(name, cfg, dcfg, stats["loop_iters"])
        for k, got in launches.items():
            check(got == want.get(k, 0), name, f"run {run}: {k} launches {got} != "
                  f"{want.get(k, 0)}")
        check(1.0 <= stats["accepted_per_cycle"] <= SPEC_K, name, f"run {run}: stats {stats}")
        check(out.shape == (BATCH, px, px, 3) and out.dtype == np.uint8, name,
              f"output {out.shape} {out.dtype}")
        check(float(out.std()) > 0, name, "constant output image")
        # finite: ControlARPipeline.generate raises on a non-finite decoded image
        calls.append(dict(stats, launches={k: v for k, v in launches.items() if v}))
    med = statistics.median(seconds)
    emit(name, ok=True, model=SPEC_CELLS[name]["size"], draft=SPEC_DRAFT_SIZE,
         layers=cfg.n_layer, draft_layers=dcfg.n_layer, quant=SPEC_CELLS[name].get("quant"),
         cache_dtype=str(kw.get("cache_dtype") or torch.bfloat16), image_px=px,
         tokens=cfg.block_size, batch=BATCH, cfg_scale=kw["cfg_scale"], top_k=kw["top_k"],
         k_draft=SPEC_K, runs=runs, build_s=build_s, seconds=seconds, median_s=med,
         images_per_s=BATCH / med, calls=calls, finite=True,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return total


def _serve_expected(cfg, scfg, slot_steps: int) -> dict:
    """Launches of one serving run: at every decode step of every layer one
    attention call and one fused KV write (into the step's in-flight rows
    with the stacked cache, plus one end-of-step write a step); steps =
    slot_steps / max_slots. Admission prefills launch no kernel."""
    steps = slot_steps // scfg.max_slots
    attn = "_q8" if scfg.cache_dtype == torch.int8 else ""
    if scfg.kv_stacked:
        return {f"flash_stacked{attn}": cfg.n_layer * steps, "append_kv": cfg.n_layer * steps,
                "append_stacked": steps}
    return {f"flash_decode_attention{attn}": cfg.n_layer * steps,
            "append_kv": cfg.n_layer * steps}


def _serve_run(engine, feats, wrappers):
    """One timed serving run of the cell's traffic, every launch count set
    to 0 just before it and read just after."""
    from controlar_tpu_torch.cells import (
        SERVE_ADD_AFTER_STEP, SERVE_REQUESTS, SERVE_UPFRONT, serve_requests, serve_staggered)

    engine.stats = {"slot_steps": 0, "useful_steps": 0}
    reqs = serve_requests(SERVE_REQUESTS, feats)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    done = serve_staggered(engine, reqs, SERVE_UPFRONT, SERVE_ADD_AFTER_STEP)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    lat = sorted(r.t_done - r.t_submit for r in done)
    stats = dict(engine.stats)
    return done, dict(
        seconds=seconds, images_per_s=len(done) / seconds,
        latency_median_s=statistics.median(lat), latency_max_s=lat[-1], stats=stats,
        waste_share=1 - stats["useful_steps"] / stats["slot_steps"],
        launches={k: v for k, v in launches.items() if v},
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30), launches


SERVE_TIMES = {}  # serving cell -> its timed runs, for the stacked cell's side by side


def phase_serve(name: str, order) -> dict:
    """A warm serving run of 8 requests, then timed runs of the cell's 16
    requests in `order` (sync, or overlapped admission: sync, overlap,
    overlap, sync runs neither mode always second). Every run's tokens and
    statistics must equal the first's and its launch counts must be exact;
    the tokens are decoded by the VQ-16 decoder into finite, non-constant
    images. A stacked cell also reports the runs of its per-layer
    counterpart. Returns the launches of the timed runs."""
    import dataclasses

    from controlar_tpu_torch.cells import CELLS, SERVE_CELLS, SERVE_REQUESTS, build_serve_cell
    from controlar_tpu_torch.models import vq as vq_model
    from controlar_tpu_torch.pipeline import to_uint8_image
    from controlar_tpu_torch.serve import Request, ServeEngine

    t0 = time.perf_counter()
    pipe, eng, feats = build_serve_cell(name, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    cfg, scfg = pipe.gpt_cfg, eng.scfg
    eng.run([Request(request_id=999 + i, label=0, cfg_scale=4.0, seed=0,
                     adapter_features=feats[i]) for i in range(8)])  # warm
    wrappers = {k: v[0] for k, v in _kernels().items()}
    engines = {"sync": eng}
    if "overlap" in order:
        engines["overlap"] = ServeEngine(
            pipe.gpt, cfg, dataclasses.replace(scfg, overlap_admission=True), device="cuda")
    runs, total, tokens = collections.defaultdict(list), collections.Counter(), None
    for mode in order:
        done, run, launches = _serve_run(engines[mode], feats, wrappers)
        runs[mode].append(run)
        total.update(launches)
        want = _serve_expected(cfg, scfg, run["stats"]["slot_steps"])
        for k, got in launches.items():
            check(got == want.get(k, 0), name, f"{mode}: {k} launches {got} != {want.get(k, 0)}")
        got_tokens = np.stack([r.tokens for r in done])
        check(got_tokens.shape == (SERVE_REQUESTS, cfg.block_size)
              and int(got_tokens.min()) >= 0 and int(got_tokens.max()) < cfg.vocab_size,
              name, f"{mode}: tokens {got_tokens.shape} out of shape or range")
        if tokens is None:
            tokens = got_tokens
            continue
        check(np.array_equal(got_tokens, tokens), name, f"{mode}: the tokens changed")
        check(run["stats"] == runs["sync"][0]["stats"], name, f"{mode}: the statistics changed")
    gh, gw = cfg.grid
    imgs = []
    with torch.inference_mode():
        for chunk in np.split(tokens, SERVE_REQUESTS // 8):
            idx = torch.as_tensor(chunk, device="cuda").long().reshape(-1, gh, gw)
            imgs.append(to_uint8_image(vq_model.decode_code(pipe.vq, pipe.vq_cfg, idx)))
    imgs = np.concatenate(imgs)
    px = gh * 16
    check(imgs.shape == (SERVE_REQUESTS, px, px, 3) and float(imgs.std()) > 0, name,
          f"images {imgs.shape}, std {float(imgs.std())}")
    # finite: to_uint8_image raises on a non-finite decoded image
    SERVE_TIMES[name] = runs
    flat = SERVE_TIMES.get(name.removesuffix("_stacked")) if scfg.kv_stacked else None
    emit(name, ok=True, model=CELLS[SERVE_CELLS[name]]["size"], cell=SERVE_CELLS[name],
         cache_dtype=str(scfg.cache_dtype), kv_stacked=scfg.kv_stacked,
         max_slots=scfg.max_slots, quantum=scfg.quantum,
         top_k=scfg.top_k, requests=SERVE_REQUESTS, tokens=cfg.block_size, build_s=build_s,
         runs=runs, images=list(imgs.shape), finite=True,
         launches_per_step={k: v / (runs["sync"][0]["stats"]["slot_steps"] // scfg.max_slots)
                            for k, v in runs["sync"][0]["launches"].items()},
         **({} if flat is None else {"per_layer_cache_runs": flat}))
    return total


# one timed call each, where a stacked cell times the same flat call again
# (one call each keeps the script well inside its time limit on a slow host)
T5_REF_TOL = 1e-4        # T5 card vs CPU, fp32, TF32 off: of the largest |output|
T5_REF_LAYERS = 2
# bf16 against fp32 on the card, relative L2 error of the output. At JAX's
# init (every matrix N(0, 0.02), no 1/sqrt(d) on the scores) softmax is sharp
# and a random T5 amplifies rounding: on the CPU at full width the gap grew
# 0.012, 0.026, 0.053, 0.090 ... 0.269 over layers 1 to 8, about 0.05 a layer.
T5_BF16_REL_L2 = {T5_REF_LAYERS: 0.05, 24: 1.2}
T5_TIMED = 10


def _t5_flops(cfg, b: int, t: int) -> float:
    """Operations of one encode: the q, k, v, o and gated-FFN matmuls and the
    two attention products, every token and layer."""
    inner = cfg.n_head * cfg.d_kv
    dense = 2 * b * t * (4 * cfg.d_model * inner + 3 * cfg.d_model * cfg.d_ff)
    attn = 2 * 2 * b * cfg.n_head * t * t * cfg.d_kv
    return cfg.n_layer * (dense + attn)


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def phase_captions() -> collections.Counter:
    """The text encoder at T5-XL's published widths (24 layers, d 2048,
    32 x 64 heads, FFN 5120, vocab 32128; weights from a seed at the JAX
    package's init) on BATCH captions given as seed-made token ids (lengths
    in [8, 120], right-padded):
    - card against CPU at T5_REF_LAYERS layers, full width, fp32 (TF32 off):
      within T5_REF_TOL of the largest |output|; bf16 against fp32 on the
      card at that depth;
    - full depth, fp32 and bf16 on the card: finite (B, 120, 2048), the bf16
      gap within T5_BF16_REL_L2; then bf16 timed (ms a batch over T5_TIMED
      calls, CUDA events; TFLOP/s; peak memory);
    - the bf16 features, as they are, with their right-padded mask into one
      ControlARPipeline.generate call of the t2i cell (GPT-XL widths at
      CELL_DEPTH's 12 layers, 512 px, CFG 7.5, Canny on its images; its
      first, unwarmed), as the JAX CLI's
      sample-t2i passes them:
      with every launch count set to 0 just before, flash_decode_attention
      and append_kv launch exactly n_layer x 1023 times each, nothing else.
    Returns the launches of the generate call."""
    import dataclasses

    from controlar_tpu_torch.cells import BATCH, build_cell, caption_token_ids
    from controlar_tpu_torch.models import t5 as tt5
    from controlar_tpu_torch.text.embedder import T5Embedder

    cfg = tt5.T5_XL
    ids, mask = caption_token_ids(BATCH, seed=31, vocab_size=cfg.vocab_size)
    small = dataclasses.replace(cfg, n_layer=T5_REF_LAYERS)
    cpu = tt5.init_t5(small, seed=3, device="cpu")
    card = copy.deepcopy(cpu).cuda()
    with torch.inference_mode():
        want = tt5.t5_encode(cpu, small, torch.from_numpy(ids), torch.from_numpy(mask))
        got = tt5.t5_encode(card, small, torch.from_numpy(ids), torch.from_numpy(mask)).cpu()
        small_bf16 = tt5.t5_encode(card.bfloat16(), small, torch.from_numpy(ids),
                                   torch.from_numpy(mask)).cpu()
    scale = float(want.abs().max())
    ref_err = float((got - want).abs().max()) / scale
    small_gap = _rel_l2(small_bf16, got)
    check(bool(torch.isfinite(got).all()) and ref_err <= T5_REF_TOL, "captions",
          f"T5 card vs CPU at {T5_REF_LAYERS} layers: {ref_err} of max |out| {scale}")
    check(small_gap <= T5_BF16_REL_L2[T5_REF_LAYERS], "captions",
          f"T5 bf16 vs fp32 at {T5_REF_LAYERS} layers: relative L2 {small_gap}")
    del cpu, card

    t0 = time.perf_counter()
    t5 = tt5.init_t5(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    emb32 = T5Embedder(t5, cfg=cfg, device="cuda")
    f32, m32 = emb32.encode(ids, mask)
    emb = T5Embedder(t5.bfloat16(), cfg=cfg, device="cuda")  # in place: the fp32 copy is gone
    del emb32
    torch.cuda.empty_cache()
    feats, fmask = emb.encode(ids, mask)
    gap = _rel_l2(feats, f32)
    check(tuple(feats.shape) == (BATCH, 120, cfg.d_model) and feats.dtype == torch.float32
          and bool(torch.isfinite(feats).all()) and bool(torch.isfinite(f32).all())
          and torch.equal(fmask.cpu(), torch.from_numpy(mask)), "captions",
          f"T5-XL features {tuple(feats.shape)} {feats.dtype}")
    check(gap <= T5_BF16_REL_L2[cfg.n_layer], "captions",
          f"T5-XL bf16 vs fp32: relative L2 {gap}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        ms = time_ms(lambda: emb.encode(ids, mask), reps=T5_TIMED)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    flops = _t5_flops(cfg, BATCH, 120)
    row = dict(t5_init_s=init_s, ref_layers=T5_REF_LAYERS, ref_max_rel_err=ref_err,
               ref_scale=scale, ref_bf16_rel_l2=small_gap, bf16_rel_l2=gap,
               bf16_cos=float(torch.nn.functional.cosine_similarity(
                   feats.flatten(), f32.flatten(), dim=0)),
               bf16_rel_l2_limits=T5_BF16_REL_L2, t5_ms=ms, t5_tflop=flops / 1e12,
               t5_tflop_per_s=flops / (ms / 1e3) / 1e12, t5_peak_mem_gb=peak,
               t5_weights_gb=sum(p.numel() * p.element_size() for p in t5.parameters()) / 2 ** 30,
               tokens=int(mask.sum()), caption_lens=mask.sum(1).tolist())
    del emb, t5, f32
    torch.cuda.empty_cache()

    pipe, kw = build_cell("t2i", device="cuda", n_layer=CELL_DEPTH["t2i"])
    kw = dict(kw, caption_emb=feats, emb_masks=fmask)
    torch.cuda.synchronize()
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    stages = {}
    t0 = time.perf_counter()
    out = pipe.generate(**kw, seed=1, timings=stages)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    per_call = _expected_per_call("t2i", pipe.gpt_cfg)
    for k, n in launches.items():
        check(n == per_call.get(k, 0), "captions", f"{k} launches {n} != {per_call.get(k, 0)}")
    px = pipe.gpt_cfg.grid[0] * 16
    check(out.shape == (BATCH, px, px, 3) and out.dtype == np.uint8 and float(out.std()) > 0,
          "captions", f"t2i output {out.shape} {out.dtype}")
    emit("captions", ok=True, model="T5-XL", layers=cfg.n_layer, d_model=cfg.d_model,
         heads=cfg.n_head, d_ff=cfg.d_ff, vocab=cfg.vocab_size, batch=BATCH, **row,
         t2i_model="GPT-XL", t2i_layers=pipe.gpt_cfg.n_layer, t2i_seconds=seconds,
         t2i_stage_seconds=stages,
         t2i_shape=list(out.shape), launches={k: v for k, v in launches.items() if v},
         launches_per_call=per_call)
    return collections.Counter(launches)


EXTRACT_IMAGES, EXTRACT_PX, EXTRACT_BATCH = 16, 512, 8
EXTRACT_C2I_IMAGES, EXTRACT_C2I_PX = 8, 256
EXTRACT_TRAIN_STEPS = 3


def phase_extract_train() -> collections.Counter:
    """Captions and images in, training out, on the card:
    - extract_tree: EXTRACT_IMAGES synthetic EXTRACT_PX px images with
      seed-made captions through the VQ-16 encoder and T5-XL (bf16, a
      word-hash stand-in for the tokenizer) into a temporary tree; images/s;
    - the stored codes equal a direct VQ encode of the saved images (ties
      within CKPT_TIE_GAP allowed);
    - pack_tree into a .car (its records the tree's files), and
      pack_control_dataset of the tree's T2IControlCodeDataset: the same
      indices through the tree dataset and CarpackControlDataset give
      identical batches, every item valid;
    - extract_c2i_tree of EXTRACT_C2I_IMAGES images in flip mode with Canny
      at EXTRACT_C2I_PX px into C2ICodeDataset: the (1, 2, T) layout;
    - T5 freed, then ShardedLoader over the .car into Trainer.fit at
      train_t2i_xl512's config for EXTRACT_TRAIN_STEPS steps: with every
      count set to 0 just before, the B10 launches exact and nothing else;
      losses finite.
    Returns the launches of the training steps."""
    import tempfile

    from PIL import Image

    from controlar_tpu_torch.cells import (build_train_cell, caption_texts, condition_images,
                                           word_tokenizer)
    from controlar_tpu_torch.config import vq_config
    from controlar_tpu_torch.data import carpack
    from controlar_tpu_torch.data.extract import extract_c2i_tree, extract_tree
    from controlar_tpu_torch.data.loader import ShardedLoader
    from controlar_tpu_torch.data.t2i_control import (C2ICodeDataset, T2IControlCodeDataset,
                                                      T2IControlConfig)
    from controlar_tpu_torch.models import t5 as tt5
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.text.embedder import T5Embedder

    vcfg = vq_config("VQ-16")
    vq = tvq.init_vq(vcfg, seed=1, device="cuda")
    images = condition_images(EXTRACT_IMAGES, EXTRACT_PX, seed=41)
    captions = caption_texts(EXTRACT_IMAGES, seed=42)
    samples = [{"image": images[i], "caption": captions[i]} for i in range(EXTRACT_IMAGES)]
    t5 = tt5.init_t5(tt5.T5_XL, seed=0, dtype=torch.bfloat16, device="cuda")
    emb = T5Embedder(t5, word_tokenizer(tt5.T5_XL.vocab_size), tt5.T5_XL, device="cuda")
    row = {}
    with tempfile.TemporaryDirectory(prefix="controlar_extract_") as tmp:
        tree = f"{tmp}/tree"
        extract_tree(tree, samples[:EXTRACT_BATCH], vq, vcfg, t5_embedder=emb,
                     image_size=EXTRACT_PX, batch_images=EXTRACT_BATCH, device="cuda")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = extract_tree(tree, samples, vq, vcfg, t5_embedder=emb, image_size=EXTRACT_PX,
                         batch_images=EXTRACT_BATCH, device="cuda")
        torch.cuda.synchronize()
        extract_s = time.perf_counter() - t0
        check(n == EXTRACT_IMAGES, "extract_train", f"extract_tree wrote {n}")
        del emb, t5
        torch.cuda.empty_cache()

        saved = np.stack([np.asarray(Image.open(f"{tree}/image/{i}.png")) for i in range(n)])
        stored = torch.from_numpy(np.stack([np.load(f"{tree}/code/{i}.npy") for i in range(n)]))
        with torch.inference_mode():
            x = torch.from_numpy(saved).cuda().float() / 127.5 - 1.0
            h = tvq._conv(vq.quant_conv, tvq.encoder_forward(vq.encoder, vcfg, x))
            _, direct = tvq.encode(vq, vcfg, x, device="cuda")
            gaps = _tie_gaps(h, tvq._codebook(vq, vcfg).float(), stored.cuda(), direct)
        grid = EXTRACT_PX // vcfg.downsample_factor
        check(stored.dtype == torch.int32 and tuple(stored.shape) == (n, grid, grid)
              and all(g <= CKPT_TIE_GAP for g in gaps), "extract_train",
              f"stored codes {stored.dtype} {tuple(stored.shape)}, tie gaps {gaps}")

        n_tree = carpack.pack_tree(tree, f"{tmp}/tree.car")
        raw = carpack.CarpackReader(f"{tmp}/tree.car")
        caps = [np.load(f"{tree}/caption_emb/{i}.npz")["caption_emb"] for i in range(n)]
        check(n_tree == n and raw.native and all(
            np.array_equal(raw[i]["tokens"], stored[i].numpy())
            and np.array_equal(raw[i]["caption_emb"], caps[i])
            and np.array_equal(raw[i]["image"], saved[i]) for i in range(n)),
            "extract_train", "pack_tree records differ from the tree's files")
        tree_ds = T2IControlCodeDataset(T2IControlConfig(
            code_path=tree, image_size=EXTRACT_PX, t5_feature_dim=tt5.T5_XL.d_model))
        packed = carpack.pack_control_dataset(tree_ds, f"{tmp}/train.car")
        car_ds = carpack.CarpackControlDataset(f"{tmp}/train.car")
        order = np.random.default_rng(43).permutation(n)
        same = True
        for b in range(0, n, EXTRACT_BATCH):
            idx = order[b:b + EXTRACT_BATCH]
            tb = tree_ds.make_batch([tree_ds[int(i)] for i in idx])
            cb = car_ds.make_batch([car_ds[int(i)] for i in idx])
            # the writer stores a 0-d field (valid) with shape (1,), as the JAX
            # package's writer does (np.ascontiguousarray), so it batches (B, 1)
            same &= tb.keys() == cb.keys() and cb["valid"].shape == (len(idx), 1) and all(
                tb[k].dtype == cb[k].dtype and np.array_equal(tb[k], cb[k].reshape(tb[k].shape))
                for k in tb)
            check(bool((tb["valid"] == 1).all()), "extract_train",
                  f"dummy items (valid 0) at {idx[tb['valid'] != 1].tolist()}")
        lens = [int(tree_ds[i]["emb_mask"].sum()) for i in range(n)]
        check(packed == n and car_ds.native and same, "extract_train",
              f"packed {packed}, native {car_ds.native}, identical batches {same}")

        c2i_imgs = condition_images(EXTRACT_C2I_IMAGES, EXTRACT_C2I_PX + 32, seed=44)
        n_c2i = extract_c2i_tree(f"{tmp}/c2i", [{"image": im, "label": 10 * i}
                                                for i, im in enumerate(c2i_imgs)], vq, vcfg,
                                 image_size=EXTRACT_C2I_PX, conditions=("canny",),
                                 device="cuda")
        pre = f"{tmp}/c2i/imagenet{EXTRACT_C2I_PX}"
        c2i = C2ICodeDataset(f"{pre}_codes", f"{pre}_labels", f"{pre}_canny_imagesnpy")
        tok = (EXTRACT_C2I_PX // vcfg.downsample_factor) ** 2
        codes = np.load(f"{pre}_codes/0.npy")
        cond = np.load(f"{pre}_canny_imagesnpy/0.npy")
        item = c2i[3]
        check(n_c2i == len(c2i) == EXTRACT_C2I_IMAGES and codes.shape == (1, 2, tok)
              and codes.dtype == np.int64 and cond.shape == (2, 1, EXTRACT_C2I_PX, EXTRACT_C2I_PX)
              and cond.dtype == np.uint8 and item["tokens"].shape == (tok,)
              and int(item["labels"]) == 30
              and item["control_map"].shape == (EXTRACT_C2I_PX, EXTRACT_C2I_PX),
              "extract_train", f"c2i tree: codes {codes.shape} {codes.dtype}, conditions "
              f"{cond.shape} {cond.dtype}, item {[(k, v.shape) for k, v in item.items()]}")
        del vq
        torch.cuda.empty_cache()

        trainer = build_train_cell("train_t2i_xl512", device="cuda",
                                   results_dir=f"{tmp}/results", log_every=1,
                                   ckpt_every=10 ** 9)[0]
        loader = ShardedLoader(car_ds, trainer.cfg.global_batch_size, seed=0)
        wrappers = {k: v[0] for k, v in _kernels().items()}
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.fit(loader, max_steps=EXTRACT_TRAIN_STEPS)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in wrappers.items()}
        cfg = trainer.gpt_cfg
        per_step = {"flash_train_fwd": cfg.n_layer * _fwd_per_layer(trainer.cfg.remat_policy),
                    "flash_train_dq": cfg.n_layer, "flash_train_dkv": cfg.n_layer}
        for k, got in launches.items():
            want = EXTRACT_TRAIN_STEPS * per_step.get(k, 0)
            check(got == want, "extract_train", f"{k} launches {got} != {want}")
        losses = [r["loss"] for r in trainer.history]
        check(len(losses) == EXTRACT_TRAIN_STEPS and bool(np.isfinite(losses).all()),
              "extract_train", f"losses {losses}")
        row.update(step_seconds=[r["seconds"] for r in trainer.history], losses=losses)
    emit("extract_train", ok=True, images=n, image_px=EXTRACT_PX, batch_images=EXTRACT_BATCH,
         extract_s=extract_s, extract_images_per_s=n / extract_s, caption_lens=lens,
         code_ties=len(gaps), tie_gaps=gaps, packed=packed, c2i_images=n_c2i,
         c2i_px=EXTRACT_C2I_PX, train_model=trainer.cfg.gpt_model, train_steps=EXTRACT_TRAIN_STEPS,
         train_s=train_s, launches={k: v for k, v in launches.items() if v},
         launches_per_step=per_step, **row)
    return collections.Counter(launches)


# ---------------------------------------------------------------------------
# Tokenizer training, multiscale control training, Adafactor
# ---------------------------------------------------------------------------

VQ_TRAIN_BATCH, VQ_TRAIN_PX = 16, 256   # train-vq's defaults, VQ-16
VQ_REF_BATCH, VQ_REF_PX = 2, 64         # card vs CPU at VQ-16's full widths
VQ_LR = 1e-4                            # train-vq's default
VQ_TIMED = {"patchgan": (2, 5), "stylegan": (1, 2)}  # warm, timed steps
VQ_LOSS_STEPS = 30
# asked for before the phase first ran on the card (PERF.md's prediction): the
# reconstruction loss of the last of VQ_LOSS_STEPS reconstruction-only steps on
# one batch at most this share of the first's (a VQ-16 at 64 px, batch 4, on the
# CPU: 0.50 -> 0.11 in 30)
VQ_LOSS_FACTOR = 0.7


def _grad_errs(card: dict, cpu: dict):
    """-> (the largest over tensors of |card - cpu| / max(|cpu|.max(), 1e-4 x
    the largest |cpu|), the three worst names), as train_reference's gate."""
    floor = 1e-4 * max(g.abs().max().item() for g in cpu.values())
    errs = {n: (card[n].cpu() - g).abs().max().item() / max(g.abs().max().item(), floor)
            for n, g in cpu.items()}
    return max(errs.values()), sorted(errs, key=errs.get)[-3:]


def _vq_models(disc_type: str, px: int, device, seed: int = 0):
    """VQ-16, a discriminator (PatchGAN ndf 64, 3 layers, or StyleGAN at px)
    and LPIPS at VGG16's widths from seeds; the tokenizer trainable."""
    from controlar_tpu_torch.config import vq_config
    from controlar_tpu_torch.models import discriminators as tdisc
    from controlar_tpu_torch.models import lpips as tlp
    from controlar_tpu_torch.models import vq as tvq

    vcfg = vq_config("VQ-16")
    vq = tvq.init_vq(vcfg, seed=seed, device=device).requires_grad_(True)
    disc = (tdisc.init_stylegan_disc(seed + 1, image_size=px, device=device)
            if disc_type == "stylegan" else tdisc.init_patchgan(seed + 1, device=device))
    return vcfg, vq, disc, tlp.init_lpips(seed, device=device)


def _vq_images(n: int, px: int, seed: int):
    """Synthetic uint8 images (n, px, px, 3) and the same in [-1, 1] on the card."""
    from controlar_tpu_torch.cells import condition_images

    u8 = condition_images(n, px, seed)
    return u8, torch.from_numpy(u8).to("cuda").float() / 127.5 - 1.0


def _vq_generator(vq, disc, lp, vcfg, x):
    """The generator's objective at step 0 with disc_start 0, the adaptive
    weight on, hinge, PatchGAN -> (loss, adaptive weight, tokenizer
    gradients, codes, reconstruction)."""
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.train import vq_loss as L

    gl, (m, recon) = L.generator_loss(vq, disc, lp, vcfg, x, 0, 0, disc_adaptive_weight=True)
    vp = dict(vq.named_parameters())
    g = dict(zip(vp, torch.autograd.grad(gl, list(vp.values()))))
    with torch.no_grad():
        _, codes = tvq.encode(vq, vcfg, x, device=x.device)
    return gl.item(), m["disc_adaptive_weight"].item(), g, codes.cpu(), recon.detach()


def _vq_discriminator(disc, x, recon):
    """The discriminator's objective at step 0 (disc_start 0, hinge) ->
    (loss, gradients)."""
    from controlar_tpu_torch.train import vq_loss as L

    dl = L.discriminator_loss(disc, x, recon, 0, 0)
    dp = dict(disc.named_parameters())
    return dl.item(), dict(zip(dp, torch.autograd.grad(dl, list(dp.values()))))


def _vq_step(vcfg, vq, disc, lp, disc_type: str, **kw):
    """A VQ train state (EMA on) and step with train-vq's optimizers."""
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import vq_step as tstep

    tx_g = topt.make_optimizer(lr=VQ_LR, beta1=0.9, beta2=0.95)
    tx_d = topt.make_optimizer(lr=VQ_LR, beta1=0.9, beta2=0.95)
    state = tstep.init_vq_train_state(vq, disc, tx_g, tx_d, use_ema=True)
    return state, tstep.make_vq_train_step(vcfg, tx_g, tx_d, lp, ema_decay=0.9999,
                                           disc_type=disc_type, **kw)


def phase_train_vq() -> collections.Counter:
    """Tokenizer training (train/vq_step.py) at VQ-16's published widths, fp32
    with TF32 off, no kernel of the port:
    - card vs CPU: the generator's and discriminator's objectives (LPIPS at
      VGG16's widths, PatchGAN ndf 64) at VQ_REF_PX, batch VQ_REF_BATCH,
      disc_start 0 with the adaptive weight: losses and the adaptive weight
      within TRAIN_REF_TOL's loss, every gradient within its grad gate;
    - timed: VQ_TRAIN_BATCH images at VQ_TRAIN_PX, disc_start 0, adaptive
      weight, hinge, EMA, with PatchGAN and with StyleGAN (VQ_TIMED warm and
      timed steps): ms a step, images/s, peak memory;
    - VQ_LOSS_STEPS reconstruction-only steps (disc_start beyond the run) on
      one fixed batch: the reconstruction loss falls to VQ_LOSS_FACTOR of its
      first value or below;
    - that state saved (save_vq_train_state), its EMA read back through
      load_vq_checkpoint bit for bit, reconstruction_eval of the batch's 16
      images: finite PSNR, MS-SSIM in [0, 1], 16 PNG pairs, samples.npz.
    Returns no launches."""
    import os
    import tempfile

    from controlar_tpu_torch import checkpoint as ckpt
    from controlar_tpu_torch.eval.reconstruction import reconstruction_eval

    vcfg, vq, disc, lp = _vq_models("patchgan", VQ_REF_PX, "cpu")
    u8, _ = _vq_images(VQ_REF_BATCH, VQ_REF_PX, 60)
    mods = {"cpu": (vq, disc, lp),
            "cuda": tuple(copy.deepcopy(m).to("cuda") for m in (vq, disc, lp))}
    xs = {dev: torch.from_numpy(u8).to(dev).float() / 127.5 - 1.0 for dev in mods}
    gen = {dev: _vq_generator(*m, vcfg, xs[dev]) for dev, m in mods.items()}
    # the discriminator on the same inputs on both: the CPU's reconstruction
    # (a code the card and the CPU find at a near tie would change the card's)
    dis = {dev: _vq_discriminator(m[1], xs[dev], gen["cpu"][4].to(dev))
           for dev, m in mods.items()}
    (gl_c, aw_c, g_c, codes_c, _), (gl_p, aw_p, g_p, codes_p, _) = gen["cuda"], gen["cpu"]
    scalar_errs = {"g_loss": abs(gl_c - gl_p) / abs(gl_p), "adaptive_weight":
                   abs(aw_c - aw_p) / abs(aw_p),
                   "d_loss": abs(dis["cuda"][0] - dis["cpu"][0]) / abs(dis["cpu"][0])}
    g_err, g_worst = _grad_errs(g_c, g_p)
    d_err, d_worst = _grad_errs(dis["cuda"][1], dis["cpu"][1])
    code_flips = int((codes_c != codes_p).sum())
    check(max(scalar_errs.values()) <= TRAIN_REF_TOL["loss"]
          and max(g_err, d_err) <= TRAIN_REF_TOL["grad"], "train_vq",
          f"card vs CPU: {scalar_errs}, grad rel err vq {g_err} ({g_worst}), disc {d_err} "
          f"({d_worst}), codes that differ {code_flips}")
    reference = dict(px=VQ_REF_PX, batch=VQ_REF_BATCH, rel_errs=scalar_errs,
                     vq_grad_rel_err=g_err, disc_grad_rel_err=d_err, code_flips=code_flips,
                     g_loss=gl_p, d_loss=dis["cpu"][0], adaptive_weight=aw_p)
    del vq, disc, lp, mods, gen, dis

    u8, x = _vq_images(VQ_TRAIN_BATCH, VQ_TRAIN_PX, 61)
    timed = {}
    for disc_type, (warm, n) in VQ_TIMED.items():
        vcfg, vq, disc, lp = _vq_models(disc_type, VQ_TRAIN_PX, "cuda")
        state, step = _vq_step(vcfg, vq, disc, lp, disc_type, disc_start=0,
                               disc_adaptive_weight=True)
        for _ in range(warm):
            state, m = step(vq, disc, state, x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        for _ in range(n):
            t0 = time.perf_counter()
            state, m = step(vq, disc, state, x)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        metrics = {k: v.item() for k, v in m.items()}
        check(bool(np.isfinite(list(metrics.values())).all()) and metrics["d_loss"] != 0
              and metrics["disc_adaptive_weight"] > 0, "train_vq",
              f"{disc_type}: metrics {metrics}")
        ms = statistics.median(seconds) * 1e3
        timed[disc_type] = dict(warm_steps=warm, step_seconds=seconds, ms_per_step=ms,
                                images_per_s=VQ_TRAIN_BATCH / (ms / 1e3),
                                peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                                metrics=metrics)
        del vq, disc, lp, state, step, m
        torch.cuda.empty_cache()

    vcfg, vq, disc, lp = _vq_models("patchgan", VQ_TRAIN_PX, "cuda", seed=2)
    state, step = _vq_step(vcfg, vq, disc, lp, "patchgan", disc_start=10 * VQ_LOSS_STEPS)
    recs = []
    for _ in range(VQ_LOSS_STEPS):
        state, m = step(vq, disc, state, x)
        recs.append(m["rec_loss"])
    recs = [r.item() for r in recs]
    factor = recs[-1] / recs[0]
    check(bool(np.isfinite(recs).all()) and factor <= VQ_LOSS_FACTOR, "train_vq",
          f"reconstruction loss {recs[0]} -> {recs[-1]}: factor {factor} > {VQ_LOSS_FACTOR}")
    with tempfile.TemporaryDirectory(prefix="controlar_vq_") as tmp:
        ckpt.save_vq_train_state(f"{tmp}/vq_checkpoints", state)
        loaded = ckpt.load_vq_checkpoint(f"{tmp}/vq_checkpoints", vcfg, device="cuda")
        check(all(torch.equal(t, state.ema_params[n]) for n, t in loaded.state_dict().items()),
              "train_vq", "the loaded checkpoint is not the state's EMA")
        t0 = time.perf_counter()
        ev = reconstruction_eval(loaded, vcfg, [u8[:8], u8[8:]], out_dir=f"{tmp}/recon_eval",
                                 device="cuda")
        eval_s = time.perf_counter() - t0
        samples = np.load(f"{tmp}/recon_eval/samples.npz")["arr_0"]
        pngs = [len(os.listdir(f"{tmp}/recon_eval/{d}")) for d in ("orig", "recon")]
    check(np.isfinite(ev["psnr"]) and 0.0 <= ev["ms_ssim"] <= 1.0 and ev["count"] == 16
          and pngs == [16, 16] and samples.shape == (16, VQ_TRAIN_PX, VQ_TRAIN_PX, 3)
          and samples.dtype == np.uint8, "train_vq",
          f"eval {ev}, PNGs {pngs}, samples {samples.shape} {samples.dtype}")
    emit("train_vq", ok=True, vq="VQ-16 (ch 128, ch_mult (1, 1, 2, 2, 4), z 256, codebook "
         "16384 x 8, l2-norm)", lpips="VGG16 widths, seed weights",
         patchgan="ndf 64, 3 layers", px=VQ_TRAIN_PX, batch=VQ_TRAIN_BATCH, lr=VQ_LR,
         precision="fp32 parameters and compute, TF32 off (cuDNN and cuBLAS)",
         reference=reference, tol=TRAIN_REF_TOL, timed=timed, loss_steps=VQ_LOSS_STEPS,
         rec_losses=recs, rec_factor=factor, asked_factor=VQ_LOSS_FACTOR, eval=ev,
         eval_s=eval_s)
    del vq, disc, lp, state, step, loaded
    torch.cuda.empty_cache()
    return collections.Counter()


# the three buckets of resolution_buckets(384, 1024, 64, 2304, 16) the phase
# runs: 1024 tokens, 1152, and the budget, 2304 (T = 2423)
MS_BUCKETS = ((512, 512), (384, 768), (1024, 576))
MS_REF_BUCKETS = ((64, 64), (64, 96))   # the JAX package's test shapes
MS_BATCH, MS_TIMED = 8, 2


def _ms_batch(hw, b: int, cls: int, caption_dim: int, seed: int, device) -> dict:
    """Synthetic images (B, H, W, 3) in [-1, 1] at the bucket's size, random
    captions left-padded to lengths in [16, 120], valid rows."""
    from controlar_tpu_torch.cells import condition_images, train_caption_lens

    h, w = hw
    u8 = np.ascontiguousarray(condition_images(b, max(h, w), seed)[:, :h, :w])
    lens = torch.as_tensor(train_caption_lens(b, seed))
    rng = np.random.default_rng(seed)
    return {"images": torch.from_numpy(u8).to(device).float() / 127.5 - 1.0,
            "caption_emb": torch.from_numpy(rng.standard_normal((b, cls, caption_dim))
                                            .astype(np.float32)).to(device),
            "emb_mask": (torch.arange(cls)[None, :] >= (cls - lens)[:, None]).to(device),
            "valid": torch.ones(b, device=device)}


def _ms_reference() -> dict:
    """A small t2i control model (3 layers of 2 x 64 heads, 120 caption
    tokens, a tiny tokenizer and HED) through the multiscale step's loss at
    MS_REF_BUCKETS, fp32, on the card and on the CPU: loss and gradients."""
    from controlar_tpu_torch.config import GPTConfig, VQConfig
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train.multiscale import make_multiscale_train_step

    cfg = GPTConfig(model_type="t2i", dim=128, n_layer=3, n_head=2, vocab_size=64,
                    caption_dim=48, block_size=16, cls_token_num=120, token_dropout_p=0.0,
                    resid_dropout_p=0.0, ffn_dropout_p=0.0, class_dropout_prob=0.0)
    acfg = tvit.ViTConfig(hidden_size=384, n_layer=1, n_head=6, pos_grid=8)
    vcfg = VQConfig(codebook_size=64, codebook_embed_dim=8, z_channels=16, ch=16)
    model = _control_model(cfg, acfg)
    frozen = {"vq": tvq.init_vq(vcfg, seed=5, device="cpu"), "hed": _small_condition_nets()["hed"]}
    devs = {"cpu": (model, frozen),
            "cuda": (copy.deepcopy(model).to("cuda"),
                     {k: copy.deepcopy(v).to("cuda") for k, v in frozen.items()})}
    out = {}
    for i, hw in enumerate(MS_REF_BUCKETS):
        got = {}
        for dev, (m, fz) in devs.items():
            fn = make_multiscale_train_step(cfg, acfg, vcfg, topt.make_optimizer(lr=TRAIN_REF_LR),
                                            "hed", frozen=fz, compute_dtype=torch.float32,
                                            device=dev)
            batch = _ms_batch(hw, 2, cfg.cls_token_num, cfg.caption_dim, 80 + i, dev)
            params = {n: p for n, p in m.named_parameters() if p.requires_grad}
            loss = fn.loss_fn(m, batch, (0, i))
            got[dev] = (loss.item(), dict(zip(params, torch.autograd.grad(
                loss, list(params.values())))))
        loss_err = abs(got["cuda"][0] - got["cpu"][0]) / abs(got["cpu"][0])
        grad_err, worst = _grad_errs(got["cuda"][1], got["cpu"][1])
        check(loss_err <= TRAIN_REF_TOL["loss"] and grad_err <= TRAIN_REF_TOL["grad"],
              "multiscale", f"{hw} card vs CPU: loss rel err {loss_err}, grad rel err "
              f"{grad_err} ({worst})")
        out[f"{hw[0]}x{hw[1]}"] = dict(loss=got["cpu"][0], loss_rel_err=loss_err,
                                      grad_rel_err=grad_err)
    return out


def phase_multiscale() -> collections.Counter:
    """Arbitrary-resolution control training (train/multiscale.py): first
    `_ms_reference` (card vs CPU within TRAIN_REF_TOL), then GPT-XL t2i at
    its published widths with train_t2i_xl512's settings (bf16 compute on
    fp32 masters, fp32 moments, remat full, dropout 0.1), the DINOv2-small
    adapter trained, HED and the VQ-16 encoder frozen, batch MS_BATCH: at
    each of MS_BUCKETS a warm step, then MS_TIMED steps with every count set
    to 0 just before (B10 launches exact: 2 x 36 forward, 36 dq, 36 dk/dv a
    step), each step timed on the host clock around the synchronised step;
    losses finite; the codes the step encoded equal a direct encode of the
    same images (ties within CKPT_TIE_GAP). Returns the launches."""
    from controlar_tpu_torch.config import vq_config
    from controlar_tpu_torch.models import control_nets as tcn
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.models import vq as tvq
    from controlar_tpu_torch.train import multiscale as tms
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import step as tstep
    from controlar_tpu_torch.train.control_step import ControlModel
    from controlar_tpu_torch.train.trainer import TrainerConfig

    reference = _ms_reference()
    tcfg = TrainerConfig(condition_type="hed", global_batch_size=MS_BATCH)
    cfg, acfg = tcfg.build_gpt_config(), tcfg.build_adapter_config()
    model = ControlModel(tgpt.init_gpt(cfg, seed=0, device="cuda"),
                         tvit.init_vit(acfg, seed=1, device="cuda"))
    frozen_names = topt.frozen_mask(dict(model.named_parameters()))
    for n, p in model.named_parameters():
        p.requires_grad_(not frozen_names[n])
    tx = topt.make_optimizer(lr=tcfg.lr, weight_decay=tcfg.weight_decay, beta1=tcfg.beta1,
                             beta2=tcfg.beta2, state_dtype=tcfg.opt_state_dtype)
    state = tstep.init_train_state(model, tx)
    vcfg = vq_config("VQ-16")
    vq = tvq.init_vq(vcfg, seed=1, device="cuda")
    step = tms.make_multiscale_train_step(cfg, acfg, vcfg, tx, "hed",
                                          frozen={"vq": vq, "hed": tcn.init_hed(seed=0,
                                                                                device="cuda")},
                                          remat_policy=tcfg.remat_policy, device="cuda")
    wrappers = {k: v[0] for k, v in _kernels().items()}
    per_step = {"flash_train_fwd": cfg.n_layer * _fwd_per_layer(tcfg.remat_policy),
                "flash_train_dq": cfg.n_layer, "flash_train_dkv": cfg.n_layer}
    encoded = {}
    encode_codes = tms.encode_codes

    def recording(v, c, images):
        encoded["codes"], encoded["images"] = encode_codes(v, c, images), images
        return encoded["codes"]

    total, rows = collections.Counter(), []
    tms.encode_codes = recording
    try:
        for i, hw in enumerate(MS_BUCKETS):
            batch = _ms_batch(hw, MS_BATCH, cfg.cls_token_num, cfg.caption_dim, 70 + i, "cuda")
            state, m = step(model, state, batch, 0)
            losses = [m["loss"].item()]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in wrappers.values():
                fn.launches = 0
            seconds = []
            for _ in range(MS_TIMED):
                t0 = time.perf_counter()
                state, m = step(model, state, batch, 0)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                losses.append(m["loss"].item())
            launches = {k: fn.launches for k, fn in wrappers.items()}
            for k, got in launches.items():
                want = MS_TIMED * per_step.get(k, 0)
                check(got == want, "multiscale", f"{hw}: {k} launches {got} != {want}")
            check(bool(np.isfinite(losses).all()), "multiscale", f"{hw}: losses {losses}")
            gh, gw = hw[0] // vcfg.downsample_factor, hw[1] // vcfg.downsample_factor
            with torch.inference_mode():
                x = encoded["images"]
                h = tvq._conv(vq.quant_conv, tvq.encoder_forward(vq.encoder, vcfg, x))
                _, direct = tvq.encode(vq, vcfg, x, device="cuda")
                gaps = _tie_gaps(h, tvq._codebook(vq, vcfg).float(),
                                 encoded["codes"].reshape(MS_BATCH, gh, gw), direct)
            check(tuple(encoded["codes"].shape) == (MS_BATCH, gh * gw)
                  and all(g <= CKPT_TIE_GAP for g in gaps), "multiscale",
                  f"{hw}: codes {tuple(encoded['codes'].shape)}, tie gaps {gaps}")
            total.update(launches)
            rows.append(dict(bucket=list(hw), grid=[gh, gw], tokens=gh * gw,
                             t=cfg.cls_token_num + gh * gw - 1, step_seconds=seconds,
                             ms_per_step=statistics.median(seconds) * 1e3,
                             images_per_s=MS_BATCH / statistics.median(seconds),
                             peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
                             losses=losses, code_ties=len(gaps)))
            del batch, m
            encoded.clear()
    finally:
        tms.encode_codes = encode_codes
    emit("multiscale", ok=True, model=tcfg.gpt_model, condition="hed", batch=MS_BATCH,
         remat=tcfg.remat_policy, precision="bf16 compute on fp32 masters, fp32 moments",
         reference=reference, tol=TRAIN_REF_TOL, buckets=rows, launches_per_step=per_step,
         launches={k: v for k, v in total.items() if v})
    del model, state, step, vq
    torch.cuda.empty_cache()
    return total


ADAFACTOR_STEPS, ADAFACTOR_LR = 10, 3e-4   # the JAX script's default lr


def phase_adafactor() -> collections.Counter:
    """toy_train at GPT-3B (24 layers, 32 x 100 heads, block 576, batch 16)
    with `--optimizer adafactor` for ADAFACTOR_STEPS steps, with every count
    set to 0 just before: ms a step (toy_train's median after two), peak
    memory, the optimizer state's size; B10 launches exact (2 x 24 forward on
    the cp.async variant at D 100, 24 dq, 24 dk/dv a step); the loss lower at
    the end. Returns the launches."""
    from controlar_tpu_torch import toy_train
    from controlar_tpu_torch.ops import flash_train as ft

    cfg = toy_train.toy_config("GPT-3B", 576)
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = toy_train.train(cfg, steps=ADAFACTOR_STEPS, batch=16, lr=ADAFACTOR_LR,
                          optimizer="adafactor", device="cuda", log=lambda m: None)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = {k: fn.launches for k, fn in wrappers.items()}
    per_step = {"flash_train_fwd": cfg.n_layer * _fwd_per_layer("full"),
                "flash_train_dq": cfg.n_layer, "flash_train_dkv": cfg.n_layer}
    for k, got in launches.items():
        want = ADAFACTOR_STEPS * per_step.get(k, 0)
        check(got == want, "adafactor", f"{k} launches {got} != {want}")
    losses = res["step_losses"]
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], "adafactor",
          f"losses {losses}: not finite, or not lower at the end")
    opt = res["state"].opt_state
    state_gb = sum(t.numel() * t.element_size() for d in (opt.v_row, opt.v_col, opt.v)
                   for t in d.values()) / 2 ** 30
    emit("adafactor", ok=True, model="GPT-3B", block_size=cfg.block_size, batch=16,
         steps=ADAFACTOR_STEPS, lr=ADAFACTOR_LR, fwd_variant=ft.fwd_variant(cfg.head_dim),
         ms_per_step=res["ms_per_step"], train_s=train_s, peak_mem_gb=peak,
         optimizer_state_gb=state_gb, losses=losses, launches_per_step=per_step,
         launches={k: v for k, v in launches.items() if v})
    del res, opt
    torch.cuda.empty_cache()
    return collections.Counter(launches)


# The evaluation phases: the c2i sampler, the evaluator's Inception and
# metrics, the mmseg DeepLabV3 segmenter and the taming VQGAN.
EVAL_REF_TOL = 1e-3        # card vs CPU, fp32 with TF32 off, of each output's largest
EVAL_RADII_TOL = 1e-5      # fp32 squared distances (~4e3) against float64, relative
EVAL_SAMPLES, EVAL_REF_IMAGES, EVAL_REF_FEATS = 16, 32, 256
EVAL_BATCHES = (64, 3)     # Inception throughput: batch, timed calls
MIOU_CLASSES = 171         # COCO-Stuff
TAMING_NAME, TAMING_PX = "vqgan_imagenet_f16_16384", 256


def _meta_flops(make, run) -> float:
    """Operations of run(make()) counted by FlopCounterMode on the meta
    device (convolutions and matmuls)."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.device("meta"):
        model = make()
        with FlopCounterMode(display=False) as counter:
            run(model)
    return float(counter.get_total_flops())


def _rel(out: torch.Tensor, ref: torch.Tensor) -> float:
    return float((out.float() - ref.float()).abs().max()) / max(float(ref.abs().max()), 1e-30)


def _narrow_taming(device):
    """A taming VQGAN at f16-16384's structure, ch 32 and a 256-entry
    codebook of embed_dim 8 drawn normal (spread as a trained one is), fp32."""
    import dataclasses

    from controlar_tpu_torch.models import taming_vqgan as tt

    cfg = dataclasses.replace(tt.TAMING_CONFIGS[TAMING_NAME], ch=32, resolution=64,
                              attn_resolutions=(4,), z_channels=32, n_embed=256, embed_dim=8)
    model = tt.init_taming(cfg, seed=41, device=device)
    gen = torch.Generator(device=device).manual_seed(42)
    with torch.no_grad():
        model.embedding.copy_(torch.randn(model.embedding.shape, generator=gen, device=device))
    return model, cfg


def phase_eval_reference():
    """The evaluation's parts on the card against the CPU (the path the
    tests hold to the JAX package), fp32 with TF32 off:
    - the InceptionV3 at full width (random weights from a seed) on 4 seed
      images of 96 x 128 (resized to 299): pool3, spatial and logits within
      EVAL_REF_TOL of each output's largest;
    - manifold radii and precision / recall membership from the card's
      fp32 distance matmuls against float64 numpy on 256 seed features of
      2048: radii within EVAL_RADII_TOL relative; each membership equal
      where no pair's float64 distance lies within EVAL_RADII_TOL of its
      radius (counted as near-ties);
    - a narrow DeepLabV3 (depth 50, base 8, head 16, 171 classes) on 2
      images at 64 x 96: logits within EVAL_REF_TOL of their largest;
    - a narrow taming VQGAN (`_narrow_taming`) on 2 images at 64 px: codes
      equal, the reconstruction within EVAL_REF_TOL of its largest."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.eval import evaluator as tev
    from controlar_tpu_torch.eval import inception as tinc
    from controlar_tpu_torch.eval.deeplabv3 import DeepLabV3
    from controlar_tpu_torch.models import taming_vqgan as tt

    rows = {}
    imgs = condition_images(4, 128, seed=33)[:, :96]
    cpu = tinc.init_inception(seed=31, device="cpu")
    card = copy.deepcopy(cpu).cuda()
    want = tinc.inception_features(cpu, imgs)
    got = tinc.inception_features(card, imgs)
    for name, o, r in zip(("pool3", "spatial", "logits"), got, want):
        rows[f"inception_{name}_rel_err"] = err = _rel(o.cpu(), r)
        check(tuple(o.shape) == tuple(r.shape) and bool(torch.isfinite(o).all())
              and err <= EVAL_REF_TOL, "eval_reference", f"inception {name}: {err}")
    del cpu, card

    rng = np.random.default_rng(34)
    ref = rng.standard_normal((EVAL_REF_FEATS, tinc.POOL_DIM)).astype(np.float32)
    smp = (rng.standard_normal((EVAL_REF_FEATS, tinc.POOL_DIM)) * 1.05 + 0.02).astype(np.float32)

    def d64(u, v):
        u, v = u.astype(np.float64), v.astype(np.float64)
        return np.maximum((u * u).sum(1)[:, None] - 2 * u @ v.T + (v * v).sum(1)[None], 0)

    for name, (f, e) in {"precision": (ref, smp), "recall": (smp, ref)}.items():
        radii = tev.manifold_radii(f, 3, device="cuda")
        want_r = np.partition(d64(f, f), 3, axis=1)[:, 3]
        r_err = float(np.max(np.abs(radii - want_r) / want_r))
        inside = tev.manifold_inside(f, radii, e, device="cuda")
        d = d64(e, f)
        want_in = (d <= want_r[None]).any(1)
        near = (np.abs(d - want_r[None]) <= EVAL_RADII_TOL * want_r[None]).any(1)
        differ = int(((inside != want_in) & ~near).sum())
        rows[f"{name}_radii_rel_err"], rows[f"{name}_near_ties"] = r_err, int(near.sum())
        rows[name] = float(inside.mean())
        rows[f"{name}_float64"] = float(want_in.mean())
        check(r_err <= EVAL_RADII_TOL and differ == 0, "eval_reference",
              f"{name}: radii {r_err}, {differ} memberships differ away from ties")

    torch.manual_seed(35)
    seg_cpu = DeepLabV3(depth=50, num_classes=MIOU_CLASSES, base_channels=8,
                        head_channels=16).eval()
    seg_card = copy.deepcopy(seg_cpu).cuda()
    x = torch.from_numpy(condition_images(2, 96, seed=36)[:, :64]).permute(0, 3, 1, 2).float()
    x = x / 127.5 - 1
    with torch.no_grad():
        want, got = seg_cpu(x), seg_card(x.cuda()).cpu()
    rows["deeplabv3_rel_err"] = err = _rel(got, want)
    check(tuple(got.shape) == (2, MIOU_CLASSES, 64, 96) and err <= EVAL_REF_TOL,
          "eval_reference", f"deeplabv3 logits {tuple(got.shape)}: {err}")

    tam_cpu, tcfg = _narrow_taming("cpu")
    tam_card = copy.deepcopy(tam_cpu).cuda()
    x = torch.from_numpy(condition_images(2, 64, seed=37)).float() / 127.5 - 1
    with torch.no_grad():
        zc, _, ic = tt.encode(tam_cpu, tcfg, x, device="cpu")
        zg, _, ig = tt.encode(tam_card, tcfg, x.cuda(), device="cuda")
        rec_c, rec_g = tt.decode(tam_cpu, tcfg, zc), tt.decode(tam_card, tcfg, zg).cpu()
    rows["taming_codes"] = int(ic.numel())
    rows["taming_codes_equal"] = bool(torch.equal(ic, ig.cpu()))
    rows["taming_rel_err"] = err = _rel(rec_g, rec_c)
    check(rows["taming_codes_equal"] and err <= EVAL_REF_TOL, "eval_reference",
          f"taming: codes equal {rows['taming_codes_equal']}, reconstruction {err}")
    emit("eval_reference", ok=True, tol=EVAL_REF_TOL, radii_tol=EVAL_RADII_TOL,
         feats=[EVAL_REF_FEATS, tinc.POOL_DIM], **rows)


def _device_profile(fn, trace: Path) -> dict:
    """One call of fn under torch.profiler: device busy ms, kernels and the
    six kernels with the most device time (`trace_decode._device_summary`)."""
    from controlar_tpu_torch.trace_decode import _device_summary

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    summary = _device_summary(trace.read_bytes(), 1, kernels=())
    trace.unlink()
    top = list(summary["top_kernels_ms_per_step"].items())[:6]
    return dict(device_busy_ms=summary["device_busy_ms_per_step"],
                kernels=summary["kernels_per_step"], top_kernels_ms=dict(top))


def _median_ms(fn, reps: int = 3):
    """A warm call of fn, then the median host-clock ms of reps synchronised
    calls. -> (the last call's output, ms)."""
    fn()
    torch.cuda.synchronize()
    seconds = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return out, statistics.median(seconds) * 1e3


def _inception_rate(model, dtype, tmp: Path) -> dict:
    """images/s and TFLOP/s of inception_features at EVAL_BATCHES[0] 384 px
    uint8 images already on the card (`_median_ms` of EVAL_BATCHES[1]
    calls); then one profiled call."""
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.eval import inception as tinc

    n, reps = EVAL_BATCHES
    x = torch.from_numpy(condition_images(n, 384, seed=38)).cuda()
    _, ms = _median_ms(lambda: tinc.inception_features(model, x, dtype), reps)
    sec = ms / 1e3
    return dict(ms=ms, images_per_s=n / sec,
                tflop_per_s=tinc.inception_flops(n) / sec / 1e12,
                profile=_device_profile(lambda: tinc.inception_features(model, x, dtype),
                                        tmp / "inception_trace.json"))


def phase_eval_fid(tmp: Path):
    """The slice's main path, generate then score: the c2i cell's pipeline
    (GPT-B c2i 384 px, Canny on its images, CFG 4.0, top_k 2000) through
    sample_c2i_fid for EVAL_SAMPLES images in batches of 8 (two generate
    calls) into tmp/samples/samples.npz, with every launch count set to 0
    just before: flash_decode_attention and append_kv exactly 2 x 12 x 575
    each, nothing else; then evaluate_all (bf16 InceptionV3 at full width,
    random weights from a seed, written as pytorch-fid's .pth and read by
    checkpoint.load_inception) against a reference npz of EVAL_REF_IMAGES
    seed images: the five numbers finite, IS in [1, 1008]; the seconds of
    each, Inception images/s at batch 64 in bf16 and fp32, peak memory.
    Returns (launches, the samples)."""
    from controlar_tpu_torch import checkpoint, convert_ref
    from controlar_tpu_torch.cells import BATCH, CELLS, build_cell, condition_images
    from controlar_tpu_torch.eval import evaluator as tev
    from controlar_tpu_torch.eval import inception as tinc
    from controlar_tpu_torch.eval.sampler import sample_c2i_fid

    pipe, kw = build_cell("c2i")
    cfg = pipe.gpt_cfg
    out_dir = tmp / "samples"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wrappers = {k: v[0] for k, v in _kernels().items()}
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    samples = sample_c2i_fid(pipe, EVAL_SAMPLES, batch_size=BATCH, cfg_scale=kw["cfg_scale"],
                             top_k=kw["top_k"], out_dir=str(out_dir), seed=0,
                             condition_images=kw["condition_images"])
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    calls = EVAL_SAMPLES // BATCH
    want = {k: calls * v for k, v in _expected_per_call("c2i", cfg).items()}
    for k, n in launches.items():
        check(n == want.get(k, 0), "eval_fid", f"{k} launches {n} != {want.get(k, 0)}")
    px = pipe.gpt_cfg.grid[0] * 16
    with np.load(out_dir / "samples.npz") as f:
        check(f.files == ["arr_0"] and f["arr_0"].shape == (EVAL_SAMPLES, px, px, 3)
              and f["arr_0"].dtype == np.uint8 and np.array_equal(f["arr_0"], samples),
              "eval_fid", f"samples.npz {f.files}")
    check(len(list((out_dir / "images").glob("*.png"))) == EVAL_SAMPLES, "eval_fid",
          "PNG count")
    sample_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del pipe
    torch.cuda.empty_cache()

    ref_path = tmp / "ref.npz"
    np.savez(ref_path, arr_0=condition_images(EVAL_REF_IMAGES, px, seed=39))
    # a seed Inception written in pytorch-fid's layout and read back as a
    # user reads the released file
    seeded = tinc.init_inception(seed=40)
    torch.save(convert_ref.inception_state_dict(seeded), tmp / "pt_inception.pth")
    inception = checkpoint.load_inception(str(tmp / "pt_inception.pth"))
    check(all(torch.equal(a, b) for a, b in zip(seeded.state_dict().values(),
                                                inception.state_dict().values())),
          "eval_fid", "load_inception is not bit for bit")
    del seeded
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    scores = tev.evaluate_all(inception, str(ref_path), str(out_dir / "samples.npz"))
    score_s = time.perf_counter() - t0
    score_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(set(scores) == {"inception_score", "fid", "sfid", "precision", "recall"}
          and all(np.isfinite(v) for v in scores.values())
          and 1.0 <= scores["inception_score"] <= tinc.NUM_LOGITS
          and all(0.0 <= scores[k] <= 1.0 for k in ("precision", "recall")),
          "eval_fid", f"scores {scores}")
    rates = {"bf16": _inception_rate(inception, torch.bfloat16, tmp),
             "fp32": _inception_rate(inception, torch.float32, tmp)}
    emit("eval_fid", ok=True, model=CELLS["c2i"]["size"], layers=cfg.n_layer, image_px=px,
         samples=EVAL_SAMPLES, reference_images=EVAL_REF_IMAGES, generate_calls=calls,
         sample_s=sample_s, score_s=score_s, scores=scores, compute_dtype="bfloat16",
         inception_batch=EVAL_BATCHES[0], inception=rates,
         inception_gflop_per_image=tinc.inception_flops(1) / 1e9,
         sample_peak_mem_gb=sample_peak, score_peak_mem_gb=score_peak,
         launches={k: v for k, v in launches.items() if v}, launches_expected=want)
    return collections.Counter(launches), samples


def phase_eval_models(tmp: Path, samples: np.ndarray):
    """The comparison and reward models at published widths, seed weights,
    fp32 with TF32 off:
    - DeepLabV3-R101 (171 classes, mmseg's widths), written as an mmseg
      .pth ({"state_dict", "meta"}) and read through load_mmseg_segmenter,
      segments 8 of eval_fid's 384 px samples (its keep-ratio resize takes
      them to 512 px) in one batch; cocostuff_miou against seed labels;
      ms of a batch (median of 3 after a warm call, host clock, the labels
      back on the host), peak memory;
    - vqgan_imagenet_f16_16384 from a seed, written as a lightning
      checkpoint ({"state_dict"}) and read through checkpoint.load_taming
      bit for bit, reconstructs 8 images at 256 px: ms (median of 3 after a
      warm call), PSNR, peak memory."""
    from controlar_tpu_torch import checkpoint, convert_ref
    from controlar_tpu_torch.cells import condition_images
    from controlar_tpu_torch.convert_mmseg import load_mmseg_segmenter
    from controlar_tpu_torch.eval.deeplabv3 import DeepLabV3
    from controlar_tpu_torch.eval.miou import cocostuff_miou
    from controlar_tpu_torch.models import taming_vqgan as tt

    torch.manual_seed(43)
    with torch.device("cuda"):
        seg = DeepLabV3(depth=101, num_classes=MIOU_CLASSES)
    path = tmp / "deeplabv3_r101.pth"
    torch.save({"state_dict": seg.state_dict(), "meta": {"mmseg_version": "1.2.2"}}, path)
    params_m = sum(p.numel() for p in seg.parameters()) / 1e6
    del seg
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    segment = load_mmseg_segmenter(str(path), device="cuda", batch_size=8)
    load_s = time.perf_counter() - t0
    images = samples[:8]
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        labels, seg_ms = _median_ms(lambda: segment(images))
    seg_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(labels.shape == images.shape[:3] and labels.min() >= 0
          and labels.max() < MIOU_CLASSES, "eval_models", f"labels {labels.shape}")
    gt = np.random.default_rng(44).integers(0, MIOU_CLASSES, images.shape[:3])
    gt[:, :8] = 255  # an ignored band
    miou = cocostuff_miou(segment, [(images, gt)])
    check(np.isfinite(miou) and 0 <= miou <= 1, "eval_models", f"mIoU {miou}")
    seg_flops = _meta_flops(lambda: DeepLabV3(depth=101, num_classes=MIOU_CLASSES),
                            lambda m: m(torch.zeros(8, 3, 512, 512)))
    del segment
    torch.cuda.empty_cache()

    cfg = tt.TAMING_CONFIGS[TAMING_NAME]
    model = tt.init_taming(cfg, seed=45)
    sd = convert_ref.taming_reference_state_dict(model)
    ckpt = tmp / "vqgan_f16_16384.ckpt"
    torch.save({"state_dict": sd}, ckpt)
    loaded, lcfg = checkpoint.load_taming(str(ckpt), TAMING_NAME)
    check(all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                loaded.state_dict().values())),
          "eval_models", "load_taming is not bit for bit")
    del model, sd
    x = torch.from_numpy(condition_images(8, TAMING_PX, seed=46)).cuda().float() / 127.5 - 1
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        rec, tam_ms = _median_ms(lambda: tt.reconstruct(loaded, lcfg, x))
    tam_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(tuple(rec.shape) == tuple(x.shape) and bool(torch.isfinite(rec).all()),
          "eval_models", f"taming reconstruction {tuple(rec.shape)}")
    mse = float(((rec.clamp(-1, 1) - x) / 2).pow(2).mean())
    tam_flops = _meta_flops(lambda: tt.TamingVQModel(cfg), lambda m: tt.decode(
        m, cfg, tt.quantize(m, cfg, tt._conv(m.quant_conv, tt.encoder_forward(
            m.encoder, torch.zeros(8, TAMING_PX, TAMING_PX, 3))))[0]))
    emit("eval_models", ok=True, dtype="float32", tf32=False,
         deeplabv3=dict(depth=101, classes=MIOU_CLASSES, params_m=params_m, batch=8,
                        input_px=list(images.shape[1:3]), load_s=load_s, ms=seg_ms,
                        tflop_per_s=seg_flops / (seg_ms / 1e3) / 1e12, peak_mem_gb=seg_peak,
                        cocostuff_miou=miou),
         taming=dict(name=TAMING_NAME, params_m=sum(p.numel() for p in loaded.parameters())
                     / 1e6, batch=8, image_px=TAMING_PX, ms=tam_ms,
                     tflop_per_s=tam_flops / (tam_ms / 1e3) / 1e12,
                     psnr_db=10 * np.log10(1.0 / max(mse, 1e-12)), peak_mem_gb=tam_peak))


CELL_RUNS = (("c2i", 1), ("c2i_depth", 1), ("t2i", 1), ("c2i_w8kv8", 1), ("c2i_3b_w4kv4", 1))
# depth cuts that keep the smoke in its time (widths unchanged; every kernel
# and launch count as at full depth, per layer): the t2i cell and the
# captions phase's t2i call run GPT-XL at 12 of its 36 layers, the GPT-3B
# stacked cell at 8 of 24, the speculative cells a GPT-3B target at 8 of 24
# layers drafted by GPT-B at 4 of 12
CELL_DEPTH = {"t2i": 12, "c2i_3b_w4kv4_stacked": 8}
SPEC_DEPTH = (8, 4)
STACKED_RUNS = ("c2i_stacked", "c2i_w8kv8_stacked", "c2i_3b_w4kv4_stacked")
SERVE_RUNS = (("serve_c2i", ("sync", "overlap", "overlap", "sync")),  # cell, timed runs
              ("serve_c2i_w8kv8", ("sync",)), ("serve_c2i_stacked", ("sync", "overlap")))
# one timed speculative call each (a minute per call): the training cells
# took the time of the second
SPEC_RUNS = (("spec_c2i_3b", 1), ("spec_c2i_3b_w8kv8", 1), ("spec_c2i_3b_w4kv4", 1))
TRAIN_RUNS = ("train_t2i_b256", "train_t2i_xl512")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    off_path_launches = {}  # kernel on no path -> the launches of its phase's checks
    main_rows, max_err = phase_kernel()
    timed = {  # kernel -> (the main-path row that is timed, max abs error, where)
        "flash_decode_attention": (main_rows["c2i"], max_err,
                                   "c2i last step: B=16 H=12 D=64 S=768 pos=575"),
        "flash_decode_attention_q8": (*phase_kernel_q8(),
                                      "c2i_w8kv8 last step: B=16 H=12 D=64 S=768 pos=575"),
        "flash_decode_attention_q4": (*phase_kernel_q4(), "c2i_3b_w4kv4 last step, split: "
                                      "B=16 H=32 D=100 S=768 pos=575"),
        "w4_matmul": (*phase_kernel_w4mm(), "GPT-3B wqkv: 16 x 3200 -> 9600"),
        "w4_ffn": (*phase_kernel_w4ffn(), "GPT-3B FFN: 16 x 3200, F=8704"),
        "flash_chunk_attention": (*phase_kernel_chunk(),
                                  "spec_c2i_3b last verify: B=16 K=4 H=32 D=100 S=768 pos=572"),
        "flash_chunk_attention_q8": (*phase_kernel_chunk_q8(),
                                     "spec_c2i_3b_w8kv8 last verify: B=16 K=4 H=32 D=100 "
                                     "S=768 pos=572"),
        "flash_chunk_attention_q4": (*phase_kernel_chunk_q4(),
                                     "spec_c2i_3b_w4kv4 last verify, split: B=16 K=4 H=32 "
                                     "D=100 S=768 pos=572"),
        "flash_stacked": (*phase_kernel_stacked(),
                          "c2i_stacked last step: L=12 B=16 H=12 D=64 S=768 layer 11 pos=575"),
        "flash_stacked_q8": (*phase_kernel_stacked_q8(),
                             "c2i_w8kv8_stacked last step: L=12 B=16 H=12 D=64 S=768 "
                             "layer 11 pos=575"),
        "flash_stacked_q4": (*phase_kernel_stacked_q4(),
                             "c2i_3b_w4kv4_stacked last step, split: L=24 B=16 H=32 D=100 "
                             "S=768 layer 23 pos=575"),
    }
    stacked_writes = phase_kernel_append_stacked()
    timed["append_stacked"] = (*stacked_writes["append_stacked"],
                               "serve_c2i_stacked step: 12 x 16 GPT-B bf16 rows of 3072 B, "
                               "S 768, per-slot pos")
    row, err, off_path_launches["cache_append_rows_stacked"] = (
        stacked_writes["cache_append_rows_stacked"])
    timed["cache_append_rows_stacked"] = (row, err, "12 x 16 GPT-B bf16 rows of 3072 B, S 768")
    appends = {**phase_kernel_append(), **phase_kernel_append_block()}
    timed["append_kv"] = (*appends["append_kv"], "c2i_3b_w4kv4 step: B=16 T=1 KV=32 D=100 "
                          "int4 split, S 768, pos 575")
    row, err, off_path_launches["cache_append_rows"] = appends["cache_append_rows"]
    timed["cache_append_rows"] = (row, err, "16 GPT-B bf16 rows of 3072 B, S 768")
    row, err, off_path_launches["cache_append_block"] = appends["cache_append_block"]
    timed["cache_append_block"] = (row, err, "16 x 4 GPT-3B bf16 rows of 12800 B, S 768")
    row, err, off_path_launches["flash_decode_attention_q8_append"] = phase_kernel_q8_append()
    timed["flash_decode_attention_q8_append"] = (
        row, err, "c2i_w8kv8 last step: B=16 H=12 D=64 S=768 pos=575")
    train_rows = phase_kernel_train()
    where = {"flash_train_fwd": "train_t2i_xl512 layer: B=8 T=1143 H=20 D=64, caption bias",
             "flash_train_dq": "train_t2i_xl512 layer: B=8 T=1143 H=20 D=64, caption bias",
             "flash_train_dkv": "train_t2i_xl512 layer: B=8 T=1143 H=20 D=64, caption bias"}
    timed.update({k: (*v, where[k]) for k, v in train_rows.items()})
    phase_reference()
    phase_serve_reference()
    phase_spec_reference()
    phase_train_reference()
    phase_condition_reference()
    phase_condition()
    launches = collections.Counter()
    launches.update(phase_checkpoint())
    torch.cuda.empty_cache()
    launches.update(phase_quality())
    torch.cuda.empty_cache()
    for name, runs in CELL_RUNS:
        launches.update(phase_cell(name, runs))
        torch.cuda.empty_cache()
    for name in STACKED_RUNS:
        launches.update(phase_stacked_cell(name))
        torch.cuda.empty_cache()
    for name, order in SERVE_RUNS:
        launches.update(phase_serve(name, order))
        torch.cuda.empty_cache()
    for name, runs in SPEC_RUNS:
        launches.update(phase_spec_cell(name, runs))
        torch.cuda.empty_cache()
    for name in TRAIN_RUNS:
        launches.update(phase_train_cell(name))
        torch.cuda.empty_cache()
    launches.update(phase_captions())
    torch.cuda.empty_cache()
    launches.update(phase_extract_train())
    torch.cuda.empty_cache()
    launches.update(phase_train_vq())
    launches.update(phase_multiscale())
    launches.update(phase_adafactor())
    torch.cuda.empty_cache()
    phase_eval_reference()
    with tempfile.TemporaryDirectory(prefix="controlar_eval_") as tmp:
        fid_launches, samples = phase_eval_fid(Path(tmp))
        launches.update(fid_launches)
        phase_eval_models(Path(tmp), samples)
    emit("total", seconds=time.perf_counter() - t_start)
    entries = []
    for name, (fn, source, replaces) in _kernels().items():
        row, err, where = timed[name]
        on_path = name not in OFF_PATH
        if on_path:
            check(launches[name] > 0, "kernels", f"{name} was not launched on the main path")
        else:
            check(launches[name] == 0, "kernels", f"{name} was launched on a path, which "
                  f"OFF_PATH says has none")
        entries.append({
            "name": name, "route": "cuda", "source": f"controlar_tpu_torch/csrc/{source}",
            "replaces": replaces,
            **({"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}),
            # the checkpoint and quality phases and the timed runs of the cells, or for a
            # kernel on no path its phase's checks
            "launches": launches[name] if on_path else off_path_launches[name],
            "on_path": on_path, **({} if on_path else {"why_no_path": OFF_PATH[name]}),
            "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "timed_at": where,
        })
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
