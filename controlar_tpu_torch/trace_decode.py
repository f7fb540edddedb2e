"""Where the time of one generation goes on the card.

    python -m controlar_tpu_torch.trace_decode --cell c2i [--seed 0] [--steps 20] [--out DIR]

Builds a cell of `controlar_tpu_torch.cells` (c2i, t2i, c2i_w8kv8,
c2i_3b_w4kv4, or a speculative cell spec_c2i_3b, spec_c2i_3b_w8kv8,
spec_c2i_3b_w4kv4) and times `ControlARPipeline.generate` itself, after a
warm call; or a stacked-cache cell (c2i_stacked, c2i_w8kv8_stacked,
c2i_3b_w4kv4_stacked) and times `generate.generate` with the per-layer and
then the stacked cache; or a serving cell (serve_c2i, serve_c2i_w8kv8,
serve_c2i_stacked) and times `ServeEngine.step` itself. Prints JSON lines:

  stages   host-clock seconds of each pipeline stage, from the pipeline's
           own `timings` (device synchronised at each stage's end):
           condition (Canny), adapter, tokens, vq_decode;
  call     (stacked-cache cells) host-clock seconds of one `generate`
           call after a warm one, with kv_stacked false and true, each
           followed by its decode line;
  decode   --steps decode steps at the middle of the cache: ms per step
           without the profiler (CUDA events recorded from the loop's
           `on_step` hook), then a torch.profiler window over the same
           steps of another call: ms per step with the profiler, device
           busy ms per step and its share of the unprofiled step, kernels
           per step, device time by kernel name, and the port's own CUDA
           kernels' device time per step and share of the busy time, in
           all and each. The trace is written to DIR/trace_<cell>.json.gz.
           For a speculative cell the unit is the cycle (k draft steps and
           one verify) in place of the decode step: --steps cycles from the
           middle of the call's cycles;
  spec     (speculative cells) the cycle's parts timed alone on the cell's
           models at the middle of the block: the k draft decode steps
           (`decode_step_multi`) and the verify (`forward_chunk`), host
           clock and CUDA events, each without the sampling between them;
           the rest of a cycle (sampling, accept/reject, the cycle's one
           read from the device) is the decode window's ms per cycle
           less the two;
  serve    (serving cells) after a warm run of 8 requests, 8 requests fill
           every slot; the first step() admits them and runs a quantum, the
           second (a full-occupancy quantum, no admission) is timed with CUDA
           events and the host clock, the third is profiled as above, per
           decode step of the quantum.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import collections
import gzip
import json
import statistics
import time
from pathlib import Path

import torch

from controlar_tpu_torch import generate as tgen
from controlar_tpu_torch.cells import (
    BATCH, CELLS, SERVE_CELLS, SPEC_CELLS, SPEC_K, STACKED_CELLS, build_cell, build_serve_cell,
    build_spec_cell, build_stacked_cell, serve_requests)

# the port's hand-written kernels, by the names of their __global__ functions
PORT_KERNELS = ("flash_decode_kernel", "flash_decode_q8_kernel", "flash_decode_q4_kernel",
                "w4_matmul_kernel", "w4_ffn_kernel", "cache_append_kernel", "kv_write_kernel",
                "kv_write_stacked_kernel",
                "chunk_kernel<chunk::Bf16Kv", "chunk_kernel<chunk::Int8Kv",
                "chunk_kernel<chunk::Int4Kv")


def stages(pipe, kw: dict) -> dict:
    """Stage seconds of one call after a warm one; for a speculative cell
    also its cycles, accepted tokens per cycle and ms per cycle of the
    tokens stage."""
    timings = {}
    pipe.generate(**kw, seed=0)  # warm call
    stats = {}
    extra = {"spec_stats": stats} if kw.get("spec_draft") else {}
    t0 = time.perf_counter()
    pipe.generate(**kw, seed=1, timings=timings, **extra)
    timings["total"] = time.perf_counter() - t0
    if stats:
        timings.update(stats, tokens_ms_per_cycle=timings["tokens"] * 1e3 / stats["loop_iters"])
    return timings


def _device_summary(raw: bytes, steps: int, kernels=PORT_KERNELS) -> dict:
    events = json.loads(raw)["traceEvents"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, end = 0.0, -1.0
    for s, e in spans:  # union of device intervals, in us
        if e > end:
            busy += e - max(s, end)
            end = e
    first, last = spans[0][0], max(e for _, e in spans)
    by_name = collections.Counter()
    for e in dev:
        by_name[e["name"][:80]] += e["dur"]
    port = {k: sum(e["dur"] for e in dev if k in e["name"]) for k in kernels}
    return {
        "device_busy_ms_per_step": busy / steps / 1e3,
        "device_busy_share_profiled": busy / (last - first),
        "kernels_per_step": len(dev) / steps,
        "port_kernels_ms_per_step": {k: v / steps / 1e3 for k, v in port.items() if v},
        "port_kernels_share_of_busy": sum(port.values()) / busy,
        "port_kernel_share_of_busy": {k: v / busy for k, v in port.items() if v},
        "top_kernels_ms_per_step": {k: v / steps / 1e3 for k, v in by_name.most_common(12)},
    }


def decode_window(run, cfg, steps: int, trace: Path, spec: bool = False) -> dict:
    """Decode steps (or speculative cycles) start..start+steps-1 of real
    generate calls `run(seed, on_step)`, where start is half way through
    the tokens (the cycles of a speculative call: at random weights a cycle
    emits about one token)."""
    start = cfg.block_size // 2

    # unprofiled: events at the end of step start-1 and of step start+steps-1
    marks = {}

    def mark(i):
        if i in (start - 1, start + steps - 1):
            marks[i] = torch.cuda.Event(enable_timing=True)
            marks[i].record()

    run(2, mark)
    torch.cuda.synchronize()
    plain_ms = marks[start - 1].elapsed_time(marks[start + steps - 1]) / steps

    # profiled: prof.step() runs at each loop step's end, so the schedule's
    # step k is loop step k and steps start..start+steps-1 are recorded; the
    # host clock is read just after recording starts and just before it ends
    raw = {}

    def save(prof):
        prof.export_chrome_trace(str(trace))
        raw["trace"] = trace.read_bytes()
        trace.unlink()

    wall = {}

    def step(i):
        if i == start + steps - 1:  # before prof.step() writes the trace
            torch.cuda.synchronize()
            wall["t1"] = time.perf_counter()
        prof.step()
        if i == start - 1:
            wall["t0"] = time.perf_counter()

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=start - 1, warmup=1, active=steps, repeat=1),
            on_trace_ready=save) as prof:
        run(2, step)
    trace.with_suffix(".json.gz").write_bytes(gzip.compress(raw["trace"]))
    summary = _device_summary(raw["trace"], steps)
    busy = summary["device_busy_ms_per_step"]
    t_cls = cfg.cls_token_num
    where = ({"cycles": [start, start + steps - 1]} if spec
             else {"positions": [t_cls + start, t_cls + start + steps - 1]})
    return {"steps": steps, **where,
            "ms_per_step": plain_ms,
            "ms_per_step_profiled": (wall["t1"] - wall["t0"]) / steps * 1e3,
            # kernel time against the unprofiled step; the profiler slows the host
            "device_busy_share": busy / plain_ms,
            **summary}


def spec_parts(pipe, kw: dict, reps: int = 10) -> dict:
    """The k draft decode steps and the verify chunk of a speculative cell,
    each timed alone at the middle of the block on fresh caches (attention
    reads the rows <= pos whatever they hold) with the cell's control
    features and CFG batch; host clock (device synchronised) and CUDA
    events, medians of `reps` after a warm call."""
    from controlar_tpu_torch import decode as dec
    from controlar_tpu_torch import spec_decode
    from controlar_tpu_torch.config import find_multiple
    from controlar_tpu_torch.generate import prepare_inputs

    cfg, dcfg, dev = pipe.gpt_cfg, pipe.draft_gpt_cfg, pipe.device
    bc = 2 * BATCH
    with torch.inference_mode():
        feats = pipe.control_features(pipe.extract_condition(kw["condition_images"]))
        inputs = dict(labels=kw["labels"], adapter_features=feats)
        _, _, fused = prepare_inputs(pipe.gpt, cfg, dev, True, **inputs)
        _, _, dfused = prepare_inputs(pipe.draft_gpt, dcfg, dev, True, **inputs)
        s_max = find_multiple(cfg.cls_token_num + cfg.block_size + SPEC_K + 64, 256)
        cache_dtype = kw.get("cache_dtype") or torch.bfloat16
        caches_t = dec.init_flat_caches(cfg, bc, s_max, cache_dtype, dev)
        caches_d = dec.init_flat_caches(dcfg, bc, s_max, cache_dtype, dev)
        rope_t, rope_d = dec.rope_tables(pipe.gpt, cfg, dev), dec.rope_tables(pipe.draft_gpt,
                                                                               dcfg, dev)
        pos = torch.full((bc,), cfg.cls_token_num + cfg.block_size // 2, dtype=torch.int32,
                         device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        tok = torch.randint(0, cfg.vocab_size, (bc,), generator=gen, device=dev)
        chunk = torch.randint(0, cfg.vocab_size, (bc, SPEC_K), generator=gen, device=dev)

    @torch.inference_mode()
    def draft():
        for j in range(SPEC_K):
            dec.decode_step_multi(pipe.draft_gpt, dcfg, caches_d, tok, pos + j, dfused,
                                  use_flash=True, rope_table=rope_d)

    @torch.inference_mode()
    def verify():
        spec_decode.forward_chunk(pipe.gpt, cfg, caches_t, chunk, pos, fused, None,
                                  use_flash=True, rope_table=rope_t)

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        wall, dev_ms = [], []
        for _ in range(reps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
            dev_ms.append(start.elapsed_time(end))
        return statistics.median(wall), statistics.median(dev_ms)

    (draft_ms, draft_ev), (verify_ms, verify_ev) = timed(draft), timed(verify)
    return {"k_draft": SPEC_K, "position": int(pos[0]), "draft_steps_ms": draft_ms,
            "draft_steps_ms_events": draft_ev, "verify_ms": verify_ms,
            "verify_ms_events": verify_ev}


def serve_window(name: str, seed: int, trace: Path) -> dict:
    """Quanta of `ServeEngine.step` at full occupancy; see the docstring."""
    pipe, eng, feats = build_serve_cell(name, seed)
    eng.run(serve_requests(8, feats, start_id=999))  # warm
    for r in serve_requests(8, feats):
        eng.add_request(r)
    eng.step()  # admission and the first quantum
    q = eng.scfg.quantum
    pos = eng.pos[:1].item()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    eng.step()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / q
    device_ms = start.elapsed_time(end) / q
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.step()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(trace))
    raw = trace.read_bytes()
    trace.unlink()
    trace.with_suffix(".json.gz").write_bytes(gzip.compress(raw))
    while eng.has_unfinished():
        eng.step()
    summary = _device_summary(raw, q)
    return {"quantum": q, "slots": eng.scfg.max_slots, "timed_positions": [pos, pos + q - 1],
            "ms_per_step": wall_ms, "ms_per_step_events": device_ms,
            "device_busy_share": summary["device_busy_ms_per_step"] / wall_ms, **summary}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cell", choices=sorted(CELLS) + sorted(SERVE_CELLS) + sorted(SPEC_CELLS)
                    + sorted(STACKED_CELLS), default="c2i")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default="traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_decode needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    device = torch.cuda.get_device_name(0)
    if args.cell in SERVE_CELLS:
        print(json.dumps({"cell": args.cell, "device": device, "serve": serve_window(
            args.cell, args.seed, out / f"trace_{args.cell}.json")}), flush=True)
        return 0
    if args.cell in STACKED_CELLS:
        pipe, kw = build_stacked_cell(args.cell, args.seed)
        for stacked in (False, True):
            def run(seed, on_step, stacked=stacked):
                return tgen.generate(pipe.gpt, pipe.gpt_cfg, kv_stacked=stacked, seed=seed,
                                     on_step=on_step, **kw)

            run(0, None)  # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(1, None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            name = f"trace_{args.cell}_{'stacked' if stacked else 'flat'}.json"
            print(json.dumps({"cell": args.cell, "device": device, "kv_stacked": stacked,
                              "call": {"seconds": seconds, "images_per_s": BATCH / seconds},
                              "decode": decode_window(run, pipe.gpt_cfg, args.steps,
                                                      out / name)}), flush=True)
        return 0
    spec = args.cell in SPEC_CELLS
    pipe, kw = (build_spec_cell if spec else build_cell)(args.cell, args.seed)
    print(json.dumps({"cell": args.cell, "device": device, "stages": stages(pipe, kw)}),
          flush=True)

    def run(seed, on_step):
        return pipe.generate(**kw, seed=seed, on_step=on_step)

    print(json.dumps({"cell": args.cell, "device": device, "decode": decode_window(
        run, pipe.gpt_cfg, args.steps, out / f"trace_{args.cell}.json", spec)}), flush=True)
    if spec:
        print(json.dumps({"cell": args.cell, "device": device, "spec": spec_parts(pipe, kw)}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
