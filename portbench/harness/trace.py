"""A short profiled slice after the window, and what the device trace says:
device time by kernel name, busy time (the union of device intervals), the
slice's wall time, the top device operations and the longest idle gaps named
by what the host was doing (the innermost host span or operator over the
gap)."""
from __future__ import annotations

import collections
import gzip
import json
import os
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


class Slice:
    """with Slice(device) as s: ... -> s.summary after the block. On a card
    the block is profiled between two synchronisations; on the CPU (tests)
    only the wall time is taken."""

    def __init__(self, device: torch.device, save: Optional[Path] = None):
        self.device, self.save, self.summary = device, save, None

    def __enter__(self):
        cuda = self.device.type == "cuda"
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        if cuda:
            torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            raw = Path(path).read_bytes()
        finally:
            os.unlink(path)
        if self.save is not None:
            self.save.parent.mkdir(parents=True, exist_ok=True)
            with gzip.open(self.save, "wb") as f:
                f.write(raw)
        self.summary = summarize(json.loads(raw)["traceEvents"], wall)
        return False


def _union(spans):
    """Sorted (start, end) -> merged intervals."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(events: List[dict], wall_s: float) -> Dict:
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    host = [e for e in events if e.get("cat") in HOST_CATS and "dur" in e]
    by_name = collections.Counter()
    count = collections.Counter()
    for e in dev:
        by_name[e["name"]] += e["dur"] * 1e-6
        count[e["name"]] += 1
    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy = sum(e - s for s, e in merged) * 1e-6
    gaps = collections.Counter()
    host.sort(key=lambda h: h["ts"])
    active, i = [], 0
    for (_, end), (start, _) in zip(merged, merged[1:]):  # gaps in time order
        mid = (end + start) / 2
        while i < len(host) and host[i]["ts"] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h["ts"] + h["dur"] >= mid]
        name = min(active, key=lambda h: h["dur"])["name"] if active else "(no host span)"
        gaps[name] += (start - end) * 1e-6
    return {
        "wall_s": wall_s,
        "busy_s": busy,
        "kernel_s": dict(by_name),
        "kernel_count": dict(count),
        "device_ops": [[n, s] for n, s in by_name.most_common(10)],
        "idle_gaps": [[n, s] for n, s in gaps.most_common(10)],
    }


def kernel_time(summary: Dict, *fragments: str) -> float:
    """Seconds of the device operations whose name holds any fragment."""
    return sum(s for n, s in summary["kernel_s"].items() if any(f in n for f in fragments))


def kernel_launches(summary: Dict, *fragments: str) -> int:
    return sum(c for n, c in summary["kernel_count"].items() if any(f in n for f in fragments))


def span(name: str):
    """A host span the profiler records (a no-op cost without a profiler)."""
    return torch.profiler.record_function(name)


def spanned(name: str, fn):
    """fn wrapped in a span of its own."""
    def wrapper(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    wrapper.__wrapped__ = fn
    return wrapper
