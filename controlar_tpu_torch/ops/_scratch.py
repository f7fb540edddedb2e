"""Per-stream scratch of the kernels that split their work across blocks.

The W4 kernels (`ops/w4_matmul.py`), the bf16 and int8 decode attention
(`ops/flash_decode.py`, `ops/flash_decode_stacked.py`) and the chunk
attention (`ops/flash_chunk.py`) cut one product or one attention into work
items whose partials meet in an fp32 workspace; the
block that arrives last at an int32 counter merges them and resets the
counter. Both come from here, at fixed addresses per (device, stream), so a
call allocates nothing besides its output and a CUDA graph can capture it.
"""
from __future__ import annotations

import functools
from typing import Dict, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_scratch: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch_for(device: torch.device, stream: int, n_counters: int,
                 n_floats: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int32 arrival counters, fp32 workspace) of at least these sizes for
    launches on `stream` of device. Launches on one stream run in order, so
    its calls share them; the counters are zero when made and every launch
    leaves them zero, and a launch writes every workspace word it reads."""
    key = (device.index, stream)
    c, w = got = _scratch.get(key, (None, None))
    if c is not None and c.numel() >= n_counters and w.numel() >= n_floats:
        return got
    if c is None or c.numel() < n_counters:
        c = torch.zeros(max(n_counters, 4096), dtype=torch.int32, device=device)
    if w is None or w.numel() < n_floats:
        w = torch.empty(max(n_floats, 1), dtype=torch.float32, device=device)
    _scratch[key] = (c, w)
    return c, w
