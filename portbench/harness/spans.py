"""The program's own spans in a profiled slice's trace.

`controlar_tpu_torch` names its layers with profiler spans (`<layer>.<part>`,
`controlar_tpu_torch/spans.py`): host events in the chrome trace that
`trace.Slice` writes on every traced run, on the clock of the device's
operations. For each span name this gives the count of complete spans, their
inclusive host ms, and the device operations (kernels, copies, fills)
launched inside them with their device ms. A device operation is matched to
the CUDA API call that launched it by `args.correlation`; it lies
inside a span when that call's host start lies within the span, on any
thread (so the autograd thread's backward launches fall under the main
thread's `train.backward`). Operations launched in no program span are
unattributed. A span cut by the slice's end (it ends at the record window's
end) is not complete, and neither it nor its launches count.

    python3 -m portbench.harness.spans .portbench_cache/traces/<cell>.json.gz

prints the table of a saved trace as one JSON object, with the device
operations each span launched most time on.
"""
from __future__ import annotations

import bisect
import collections
import gzip
import json
import re
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from portbench.harness import env, manifest
from portbench.harness.trace import DEVICE_CATS

PROGRAM_SPAN = re.compile(r"^[a-z][a-z0-9_]*\.[a-z0-9_.]+$")
SPAN_CAT = "cpu_op"  # the program's spans are the profiler's fast record functions
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW_END = "Record Window End"
TOP = 5  # device operations a span's row of the table names


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _inside(merged: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(merged, (t, float("inf"))) - 1
    return i >= 0 and merged[i][0] <= t <= merged[i][1]


class Spans:
    """The complete program spans of one trace and the device operations,
    each with the host time of the call that launched it (None if the trace
    holds no such call). Times in microseconds, as the trace has them."""

    def __init__(self, events: List[dict]):
        end = _window_end(events)
        self.spans: Dict[str, List[Tuple[float, float]]] = {}
        for e in events:
            if e.get("cat") == SPAN_CAT and "dur" in e and \
                    PROGRAM_SPAN.match(e.get("name", "")):
                s, f = float(e["ts"]), float(e["ts"]) + float(e["dur"])
                if f < end:
                    self.spans.setdefault(e["name"], []).append((s, f))
        launch = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") in LAUNCH_CATS and corr is not None:
                launch[corr] = float(e["ts"])
        self.device: List[Tuple[float, Optional[float], str]] = [
            (float(e["dur"]), launch.get(e.get("args", {}).get("correlation")), e.get("name", ""))
            for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        self._merged = {n: _merge(v) for n, v in self.spans.items()}
        self._all = _merge([iv for v in self.spans.values() for iv in v])

    def count(self, name: str) -> int:
        return len(self.spans.get(name, ()))

    def host_ms(self, name: str, within: Optional[str] = None) -> float:
        """Inclusive host ms of the complete `name` spans (those inside a
        complete `within` span, if given)."""
        outer = self._merged.get(within, []) if within else None
        return 1e-3 * sum(f - s for s, f in self.spans.get(name, ())
                          if outer is None or (_inside(outer, s) and _inside(outer, f)))

    def _launched(self, name: str) -> List[Tuple[float, Optional[float], str]]:
        merged = self._merged.get(name, [])
        return [d for d in self.device if d[1] is not None and _inside(merged, d[1])]

    def device_ms(self, name: str) -> float:
        """Device ms of the operations launched inside complete `name` spans."""
        return 1e-3 * sum(d[0] for d in self._launched(name))

    def launches(self, name: str) -> int:
        """Device operations launched inside complete `name` spans."""
        return len(self._launched(name))

    def total_device_ms(self) -> float:
        return 1e-3 * sum(d[0] for d in self.device)

    def unattributed(self) -> Tuple[int, float]:
        """(count, device ms) of the operations launched in no program span."""
        out = [d[0] for d in self.device if d[1] is None or not _inside(self._all, d[1])]
        return len(out), 1e-3 * sum(out)

    def table(self) -> dict:
        """Each span's count, host ms, device ms and launches, with the TOP
        device operations launched inside it by device ms; the total and the
        unattributed rest."""
        out = {}
        for name in sorted(self.spans):
            ops = self._launched(name)
            by_op = collections.Counter()
            for dur, _, op in ops:
                by_op[op] += 1e-3 * dur
            out[name] = {"count": self.count(name), "host_ms": self.host_ms(name),
                         "device_ms": 1e-3 * sum(d[0] for d in ops), "launches": len(ops),
                         "top": by_op.most_common(TOP)}
        n, ms = self.unattributed()
        return {"spans": out, "device_ms": self.total_device_ms(),
                "unattributed": {"ops": n, "device_ms": ms}}


def _window_end(events: List[dict]) -> float:
    """The record window's end: a span still open when the profiler stopped
    ends there. Else the profiler's own trace span's end, else never."""
    for e in events:
        if e.get("name") == WINDOW_END and e.get("ph") == "i":
            return float(e["ts"])
    for e in events:
        if e.get("cat") == "Trace" and "dur" in e:
            return float(e["ts"]) + float(e["dur"])
    return float("inf")


def trace_path(workload: str) -> Path:
    """Where `run.py` has `trace.Slice` save the cell's profiled slice."""
    return manifest.ROOT / env.CACHE_DIR / "traces" / f"{workload}.json.gz"


def load(path: Path) -> Spans:
    """The spans of a saved trace (.json or .json.gz)."""
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rt") as f:
        return Spans(json.load(f)["traceEvents"])


def for_slice(ctx, kind: str) -> Optional[Spans]:
    """The spans of this traced run's slice, parsed once a run (kept in the
    run's slice facts); None untraced, for a slice of another kind, on the
    CPU (no device operation) or without the trace."""
    s = ctx.slice
    if not s or s.get("kind") != kind or s.get("busy_s", 0) <= 0:
        return None
    if "program_spans" not in s:
        path = trace_path(ctx.workload)
        s["program_spans"] = load(path) if path.exists() else None
    return s["program_spans"]


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    print(json.dumps(load(Path(argv[0])).table()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
