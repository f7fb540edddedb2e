"""Time the int4 decode-attention kernel at several chunk lengths.

    python3 probe_q4_chunk.py [--chunks 32 64 128]

The kernel (`controlar_tpu_torch/csrc/flash_decode_q4.cu`) splits each
(batch row, head) into chunks of `chunk::kChunk` cache rows at every head
dim, which `ops.flash_decode.CHUNK_ROWS["int4"]` mirrors. This builds one
variant of the kernel per length c, from a copy of the source with that
constant replaced by c in a temporary directory under the package's build
directory (the builds in parallel; the package's own library is not
touched), checks each against the plain version, and times its flat entry
with `chip_smoke.time_ms` (median of 20 launches, L2 flushed) at the GPT-3B
c2i step (16 rows, 32 heads x 100, split-rope) and at the w4kv4 spec
draft's GPT-B widths (12 x 64, interleaved), each at pos 575 (the last
step) and 255. Prints the card's name and power limit, then one JSON line
per (length, case). Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import tempfile
from pathlib import Path

import torch

import chip_smoke as cs
from controlar_tpu_torch import _build
from controlar_tpu_torch.ops import flash_decode as fd
from controlar_tpu_torch.ops._scratch import _scratch_for
from controlar_tpu_torch.quant import quantize_kv_rows_4

CASES = (("3b_split", 32, 100, True), ("b_interleaved", 12, 64, False))  # name, H, D, split
POSITIONS = (575, 255)
B, S = 16, 768
SOURCE = _build.CSRC_DIR / "flash_decode_q4.cu"
CONSTANT = "static constexpr int CHUNK = chunk::kChunk;"


def _build_variants(chunks, out_dir: Path) -> dict:
    """chunk -> the library built from the source with CHUNK = chunk (one
    nvcc a length, all started together; the shared headers are found
    through -I)."""
    src = SOURCE.read_text()
    if src.count(CONSTANT) != 1:
        raise SystemExit(f"{SOURCE.name}: the line {CONSTANT!r} is not there once")
    procs = {}
    for c in chunks:
        cu = out_dir / f"flash_decode_q4_chunk{c}.cu"
        cu.write_text(src.replace(CONSTANT, f"static constexpr int CHUNK = {c};"))
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR),
               "-o", str(cu.with_suffix(".so")), str(cu)]
        procs[c] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
    libs = {}
    for c, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"chunk {c}: nvcc exited {proc.returncode}\n{log}")
        libs[c] = ctypes.CDLL(str(out_dir / f"flash_decode_q4_chunk{c}.so"))
    return libs


def _call(entry, chunk, q, rows, scale, pos, h, d, split):
    """The variant's flat entry at an int pos, with a plan of its chunk length."""
    n_chunks = max(1, -(-min(pos + 1, S) // chunk))
    stream = torch.cuda.current_stream().cuda_stream
    counters, ws = _scratch_for(q.device, stream, B * h, B * h * n_chunks * (d + 4))
    out = torch.empty_like(q)
    err = entry(q.data_ptr(), rows.data_ptr(), scale.data_ptr(), None, 0, pos, None,
                out.data_ptr(), 0, B, S, h, d, int(split), ws.data_ptr(), counters.data_ptr(),
                chunk, n_chunks, stream)
    if err != 0:
        raise RuntimeError(f"flash_decode_q4 at chunk {chunk}: cudaError {err}")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", nargs="+", type=int, default=[32, 64, 128])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        return _probe(args.chunks, _build_variants(args.chunks, Path(tmp)), smi)


def _probe(chunks, libs: dict, smi: str) -> int:
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    for name, h, d, split in CASES:
        q, kv = cs._slab(gen, B, S, h, d)
        rows, scale = quantize_kv_rows_4(kv, h, split=split)
        del kv
        for chunk in chunks:
            entry = fd._bind(libs[chunk].flash_decode_q4, 3, False, True)
            for pos in POSITIONS:
                out = _call(entry, chunk, q, rows, scale, pos, h, d, split)
                torch.cuda.synchronize()
                ref = fd.flash_decode_attention_q4_ref(q, rows, scale, pos, n_head=h, head_dim=d,
                                                       split=split)
                err, ok = cs._kernel_error(out, ref)
                if not ok:
                    raise SystemExit(f"{name} chunk {chunk} pos {pos}: max_abs_err {err}")
                ms = cs.time_ms(lambda: _call(entry, chunk, q, rows, scale, pos, h, d, split),
                                flush=flush)
                print(json.dumps(dict(probe="q4_chunk", case=name, h=h, d=d, split=split,
                                      pos=pos, chunk=chunk, warps=B * h * -(-(pos + 1) // chunk),
                                      ms=ms, max_abs_err=err, nvidia_smi=smi)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
