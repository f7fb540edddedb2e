"""Where the time of a training step goes on the card.

    python -m controlar_tpu_torch.trace_train --cell train_t2i_b256 [--seed 0] [--steps 3] [--out DIR]

Builds a training cell of `controlar_tpu_torch.cells` (train_t2i_b256,
train_t2i_xl512) and runs `Trainer.fit` on its fixed batch: 2 warm steps,
--steps steps timed on the host clock around each synchronised step (the
trainer logs every step), then --steps steps under the trainer's own
torch.profiler window. Prints one JSON line: ms per step without the
profiler (median), the device's busy ms per profiled step and its share of
the unprofiled step, kernels per step, the top kernels by device time, and
the three flash training kernels' device time per step and share of the
busy time. The trace is written to DIR/trace_<cell>.json.gz.

Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import gzip
import json
import statistics
from pathlib import Path

import torch

from controlar_tpu_torch.cells import TRAIN_CELLS, FixedBatchLoader, build_train_cell
from controlar_tpu_torch.trace_decode import _device_summary

TRAIN_KERNELS = ("flash_train_fwd_kernel", "flash_train_fwd_tma_kernel", "flash_train_dq_kernel",
                 "flash_train_dkv_kernel")
WARM = 2


def trace_cell(name: str, seed: int, steps: int, out: Path) -> dict:
    profile_dir = out / f"profile_{name}"
    trainer, batch = build_train_cell(name, seed, log_every=1, ckpt_every=10 ** 9,
                                      profile_dir=str(profile_dir),
                                      profile_start_step=WARM + steps, profile_num_steps=steps)
    trainer.fit(FixedBatchLoader(batch, WARM + 2 * steps), max_steps=WARM + 2 * steps)
    torch.cuda.synchronize()
    timed = [r["seconds"] for r in trainer.history if WARM < r["step"] <= WARM + steps]
    ms = statistics.median(timed) * 1e3
    raw_path = profile_dir / f"trace_step{WARM + steps}.json"
    raw = raw_path.read_bytes()
    trace = out / f"trace_{name}.json.gz"
    with gzip.open(trace, "wb") as f:
        f.write(raw)
    raw_path.unlink()
    profile_dir.rmdir()
    summary = _device_summary(raw, steps, TRAIN_KERNELS)
    return {"cell": name, "steps": steps, "ms_per_step": ms, "step_seconds": timed,
            "device_busy_share": summary["device_busy_ms_per_step"] / ms,
            **summary, "trace": str(trace),
            "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=sorted(TRAIN_CELLS), required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default="traces")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("trace_train needs a CUDA device")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(json.dumps(trace_cell(args.cell, args.seed, args.steps, out)), flush=True)


if __name__ == "__main__":
    main()
