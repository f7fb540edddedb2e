#!/usr/bin/env python3
"""One run of one benchmark cell of `controlar_tpu_torch` on NVIDIA cards.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, loop,
metric readers and limits are found by name from `BENCHMARK.json` (see
`harness/manifest.py`). A run makes the weights and inputs from the seed on
the card, warms up the cell's shapes (set-up), measures for --seconds, then
with --trace 1 profiles a short slice, and compares what the window produced
with the plain reference (`reference/`). The last line of standard output is
one JSON object: correct, attempted, failed, metrics (the end-to-end ones, or
with --trace 1 the per-layer ones), device and, traced, breakdown; last in it,
`checked`, each compared number beside its limit (also the last lines of
standard error).

Exits with 3 and no result without the cards the cell asks for, and with 4
if a JAX module was loaded. `--control 1` runs the program's own
lower-precision paths in its place (the comparison's control; never in the
benchmark's own runs).
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run(argv=None, require_cuda: bool = True, root: Path = ROOT, t0: float = T0) -> dict:
    """One run; -> the result object (printed by `main`). require_cuda=False
    runs on the CPU (the tests, at tiny sizes)."""
    args = parse(argv)
    from portbench.harness import env, manifest

    env.prepare(root)
    m = manifest.Manifest(root)
    cell = m.workload(args.workload)
    cfg, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    limits = m.limits(cell["name"])

    import torch

    from portbench.harness import check as chk
    from portbench.harness.context import Context

    if require_cuda:
        env.cards_or_exit(cell["chips"])
    device = torch.device("cuda" if require_cuda else "cpu")
    torch.manual_seed(args.seed % 2 ** 63)
    loop = m.loop(traffic["loop"])(cfg, traffic, args.seed, device, bool(args.trace),
                                   bool(args.control))
    loop.setup(args.seconds)
    setup_s = time.perf_counter() - t0
    window = loop.window(args.seconds)
    sliced = None
    if args.trace:
        save = root / env.CACHE_DIR / "traces" / f"{cell['name']}.json.gz"
        sliced = loop.trace_slice(traffic["trace_steps"], save)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    ctx = Context(cfg=cfg, traffic=traffic, workload=cell["name"], seed=args.seed,
                  setup_s=setup_s, peak_bytes=peak, window=window, slice=sliced)
    metrics = {}
    for spec in m.metrics(cell["name"], "per_layer" if args.trace else "end_to_end"):
        value = m.reader(spec["name"])(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    loop.free()
    numbers, attempted, failed = loop.check(limits)
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    if sliced is not None:
        device_info.update(busy_s=sliced["busy_s"], window_s=sliced["wall_s"])
    result = {"correct": chk.verdict(numbers, failed), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": device_info}
    if sliced is not None:
        result["breakdown"] = {"device_ops": sliced["device_ops"],
                               "idle_gaps": sliced["idle_gaps"]}
    if cuda:
        result["power"] = env.power_limit()
    result["checked"] = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    chk.print_numbers(numbers, failed, attempted)
    return result


def main(argv=None) -> int:
    from portbench.harness import env

    result = run(argv)
    bad = env.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
