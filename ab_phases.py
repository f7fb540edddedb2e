"""Run phases of chip_smoke.py from two checkouts in alternation on one card.

    python3 ab_phases.py --base DIR --phases kernel_w4mm kernel_w4ffn
    python3 ab_phases.py --base DIR --phases train_cell:train_t2i_xl512

Runs the checkout at DIR and this one in the order base, head, head, base,
each in a new process in the checkout's root that calls
`chip_smoke.phase_device()` and then `phase_<name>()` for every phase named
(`phase_<name>(arg)` for one given as name:arg),
with TF32 off as `chip_smoke.main` sets it, so each checkout builds and runs
its own kernels. Every JSON line a run prints is printed again with the
checkout (`tree`) and the run's index (`run`) added; other lines are kept
as `text`. Interleaving the two checkouts in one call keeps the card, its
power limit and its host the same for both versions. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ORDER = ("base", "head", "head", "base")
TIMEOUT_S = 900  # a run builds its checkout's kernels, then runs the phases
RUN = ("import sys, torch, chip_smoke as c\n"
       "torch.backends.cuda.matmul.allow_tf32 = False\n"
       "torch.backends.cudnn.allow_tf32 = False\n"
       "c.phase_device()\n"
       "for spec in sys.argv[1:]:\n"
       "    name, _, arg = spec.partition(':')\n"
       "    getattr(c, 'phase_' + name)(*([arg] if arg else []))\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True, help="root of the checkout compared against")
    ap.add_argument("--phases", nargs="+", required=True,
                    help="chip_smoke phase names, or name:arg")
    args = ap.parse_args()
    roots = {"base": Path(args.base).resolve(), "head": Path(__file__).resolve().parent}
    for run, tree in enumerate(ORDER):
        proc = subprocess.run([sys.executable, "-c", RUN, *args.phases], cwd=roots[tree],
                              capture_output=True, text=True, timeout=TIMEOUT_S)
        for line in proc.stdout.splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                rec = None
            if not isinstance(rec, dict):
                rec = {"text": line}
            print(json.dumps({"tree": tree, "run": run, **rec}), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
