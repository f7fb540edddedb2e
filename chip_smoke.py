#!/usr/bin/env python3
"""Drive the PyTorch port (controlar_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Run from the repository root. Phases, each printing one JSON line and each
ending the run with a non-zero exit when it fails:

  device     the card's name and power limit (nvidia-smi), the kernel build;
  kernel     every CUDA kernel against its plain PyTorch version at the main
             path's shapes, with its time, the plain version's, one PyTorch
             library call's and the bound;
  reference  a small model on the card against the same model on the CPU
             (the CPU path is the one the tests hold to the JAX package);
  c2i        GPT-B class-to-image at 384 px through ControlARPipeline:
             Canny -> DINOv2-small -> CFG decode -> VQ-16, batch 8;
  t2i        GPT-XL text-to-image at 512 px with left-padded captions;
then the `kernels` line and, last, the `ok` line. Both cells are built by
`controlar_tpu_torch.cells`; weights are random, made from fixed seeds. TF32 is off throughout, so fp32 matmuls and convolutions
run in full fp32 and the reference comparisons are fp32 against fp32.
Exits non-zero, printing no result, when there is no CUDA device.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP32_FLOPS = 67e12          # H100 SXM fp32 outside the tensor cores
# kernel vs plain version: |out - ref| <= ATOL + RTOL * |ref|. Both round the
# output to bf16, whose step is 2**-7 relative: RTOL covers one step at any
# size, ATOL one step below 0.5. At the deepest decode step |out| ~ 0.02, so a
# dropped block of rows or a misapplied bias (~1e-2) fails.
KERNEL_ATOL, KERNEL_RTOL = 2e-3, 1e-2
REF_TOL = 1e-3              # fp32 model on card vs CPU; bf16 cache identical


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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
    """-> (max abs error, whether every element is within the limit)."""
    err = (out.float() - ref.float()).abs()
    ok = bool((err <= KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()).all())
    return err.max().item(), ok and bool(torch.isfinite(out).all())


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
    flops = 4 * rows * h * d
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernel():
    """flash_decode_attention at the main path's shapes: 16 rows (batch 8
    with CFG); c2i GPT-B (12 x 64 heads, 768 cache rows = 577 rounded up to
    256, pos 0..575), t2i GPT-XL (20 x 64 heads, 1280 rows = 1144 rounded
    up, pos 119..1142, caption bias), and head dims 100 and 128 (GPT-3B,
    GPT-7B). Each case with and without the left-padded bias; the last
    decode step of each is timed."""
    import torch.nn.functional as F

    from controlar_tpu_torch.ops.flash_decode import (
        flash_decode_attention,
        flash_decode_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    b = 16

    def slots(*p):
        return torch.tensor(p, dtype=torch.int32, device="cuda")

    c2i_slots = slots(0, 1, 100, 255, 256, 300, 400, 500, 575, 575, 10, 20, 30, 40, 50, 767)
    t2i_slots = slots(119, 120, 121, 200, 400, 631, 700, 800, 900, 1000, 1100, 1142, 1142,
                      130, 1279, 500)
    cases = [  # name, heads, head_dim, cache rows, caption columns, positions, timed pos
        ("c2i", 12, 64, 768, 120, (0, 1, 255, 256, 575, c2i_slots), 575),
        ("t2i", 20, 64, 1280, 120, (119, 120, 631, 1142, t2i_slots), 1142),
        ("d100", 32, 100, 768, 120, (0, 1, 255, 256, 575, c2i_slots), 575),
        ("d128", 32, 128, 768, 120, (0, 1, 255, 256, 575, c2i_slots), 575),
    ]
    results, max_err, main = [], 0.0, {}
    for name, h, d, s, t_cls, positions, timed in cases:
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
        for col_bias in (None, bias):
            ms = time_ms(lambda: flash_decode_attention(q, kv, timed, col_bias, n_head=h),
                         flush=flush)
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
            results.append(row)
            # the rows each cell's main path runs at its last step
            if (name, col_bias is None) in (("c2i", True), ("t2i", False)):
                main[name] = row
    emit("kernel", ok=True, name="flash_decode_attention", max_abs_err=max_err,
         atol=KERNEL_ATOL, rtol=KERNEL_RTOL, timings=results)
    return main, max_err


def phase_reference():
    """A small fp32 model on the card (kernel path) against the same weights
    on the CPU (plain path): Canny bit for bit, the adapter, prefill and
    three decode steps, and the VQ decoder."""
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
    logits = {}
    for dev in ("cuda", "cpu"):
        gpt = gpt.to(dev)
        caches = tdec.init_flat_caches(cfg, 3, 256, torch.bfloat16, dev)
        lg, caches = tdec.prefill_flat(gpt, cfg, caches, prefix.to(dev), fused3.to(dev),
                                       col_mask.to(dev))
        out = [lg.cpu()]
        full = torch.cat([col_mask, torch.ones(3, 251, dtype=torch.bool)], 1).to(dev)
        for i in range(3):
            lg, caches = tdec.decode_step_flat(gpt, cfg, caches, toks[:, i].to(dev), 5 + i,
                                               fused3.to(dev), full, use_flash=True)
            out.append(lg.cpu())
        logits[dev] = torch.stack(out)
    errs["logits"] = (logits["cuda"] - logits["cpu"]).abs().max().item()
    for k, v in errs.items():
        check(v <= REF_TOL, "reference", f"{k}: card vs CPU max_abs_err {v} > {REF_TOL}")
    emit("reference", ok=True, canny_bit_exact=True, max_abs_err=errs, tol=REF_TOL)


def phase_cell(name: str, runs: int) -> int:
    """One warm `ControlARPipeline.generate` call, then `runs` timed calls
    with the launch counts set to 0 before them. Returns the launches."""
    from controlar_tpu_torch.cells import BATCH, CELLS, build_cell
    from controlar_tpu_torch.ops.flash_decode import flash_decode_attention

    pipe, kw = build_cell(name)
    cfg = pipe.gpt_cfg
    px = CELLS[name]["image_px"]
    pipe.generate(**kw, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    seconds, outs = [], []
    flash_decode_attention.launches = 0
    for run in range(runs):
        t0 = time.perf_counter()
        outs.append(pipe.generate(**kw, seed=1 + run))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    launches = flash_decode_attention.launches
    want = runs * cfg.n_layer * (cfg.block_size - 1)
    check(launches == want, name, f"kernel launches {launches} != {want}")
    for out in outs:
        check(out.shape == (BATCH, px, px, 3) and out.dtype == np.uint8, name,
              f"output {out.shape} {out.dtype}")
        check(float(out.std()) > 0, name, "constant output image")
    # finite: ControlARPipeline.generate raises on a non-finite decoded image
    med = statistics.median(seconds)
    emit(name, ok=True, model=CELLS[name]["size"], image_px=px, tokens=cfg.block_size,
         batch=BATCH, cfg_scale=kw["cfg_scale"], top_k=kw["top_k"], runs=runs,
         seconds=seconds, median_s=med, images_per_s=BATCH / med, shape=list(outs[0].shape),
         dtype=str(outs[0].dtype), finite=True, launches=launches, expected_launches=want,
         peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_device()
    main_rows, max_err = phase_kernel()
    phase_reference()
    launches = phase_cell("c2i", runs=3)
    torch.cuda.empty_cache()
    launches += phase_cell("t2i", runs=3)
    emit("total", seconds=time.perf_counter() - t_start)
    main_row = main_rows["c2i"]
    print(json.dumps({"kernels": [{
        "name": "flash_decode_attention",
        "route": "cuda",
        "source": "controlar_tpu_torch/csrc/flash_decode.cu",
        "replaces": "controlar_tpu/ops/flash_decode2.py:24",
        "launches": launches,  # c2i and t2i timed runs
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "timed_at": "c2i last step: B=16 H=12 D=64 S=768 pos=575",
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
