#!/usr/bin/env python3
"""The controls of the comparison that decides `correct`, at a cell's own
size (never run by the benchmark's own runs):

  python3 portbench/controls.py --workload <cell> --seeds 11 12 13 [--fault none|fp8|half_batch]

For a training cell the reference itself is put in the program's place:
`fp8` computes every matrix product on float8 (e4m3, a scale per row) inputs,
the precision below the configuration's bf16 compute; `half_batch` leaves
out half of each batch and takes the mean over the rest (a fault the check
must catch); `none` is the fp32 reference against itself. Both sides
replay the configuration's dropout from the same keys. Prints one JSON
line per seed with the numbers `correct` compares. For the other cells the
control is the program's own lower-precision path: `run.py --control 1`.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def fp8_matmul(x, w):
    """x @ w.T with both inputs rounded to e4m3 (448 at a row's largest
    magnitude), the rounding passed straight through in the backward."""
    import torch

    def q(t):
        s = t.detach().abs().amax(-1, keepdim=True).clamp(min=1e-12) / 448.0
        r = (t.detach() / s).to(torch.float8_e4m3fn).float() * s
        return t + (r - t).detach()

    return q(x) @ q(w).t()


class Readings:
    """The program side of `reference_train_numbers`, read off a reference
    step put in the program's place."""

    def __init__(self, cfg, traffic, seed, device, fault, drop_seed=None):
        from portbench.harness import program
        from portbench.harness import traffic as tr
        from portbench.reference import gpt as ref_gpt
        from portbench.reference.train import Step

        self.cfg, self.traffic, self.device, self.drop_seed = cfg, traffic, device, drop_seed
        g = cfg["gpt"]
        self.batches = [tr.train_batch(g, traffic["batch"], cfg["image_px"], traffic["caption_min"],
                                       traffic["caption_max"], seed, i)
                        for i in range(traffic["checked_steps"])]
        w = program.reference_weights(cfg, seed, device, parts=("gpt", "adapter"))
        mm = fp8_matmul if fault == "fp8" else ref_gpt.plain_matmul
        step = Step(w["gpt"], w["adapter"], cfg, mm=mm, rows_per_block=traffic["reference_rows"],
                    drop_seed=drop_seed)
        p0 = {k: v.detach().clone() for k, v in step.params.items()}
        self.losses = []
        import torch

        for k in range(traffic["checked_steps"]):
            batch = {n: torch.as_tensor(v, device=device) for n, v in self.batches[k].items()}
            rows = None
            if fault == "half_batch":
                rows = torch.arange(traffic["batch"] // 2, device=device)
            loss, grads = step.loss_and_grads(batch, rows)
            clipped = step.apply(grads)
            self.losses.append(loss)
            if k == 0:
                self.grad_norms = {n: float(gr.norm()) for n, gr in clipped.items()}
            del grads, clipped
        self.update_norms = {n: float((step.params[n].detach() - p0[n]).norm()) for n in p0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default="fp8", choices=("none", "fp8", "half_batch"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench.harness import env, manifest, program
    from portbench.harness.loops import free_device
    from portbench.reference import exact_fp32

    env.prepare(ROOT)
    exact_fp32()
    m = manifest.Manifest(ROOT)
    cell = m.workload(args.workload)
    cfg, traffic = m.config(cell["config"]), m.traffic(cell["traffic"])
    if traffic["loop"] != "train":
        raise SystemExit("for this cell the control is `run.py --control 1`")
    train = m.load("loops", "train")
    device = torch.device("cpu" if args.cpu else "cuda")
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog = Readings(cfg, traffic, seed, device, args.fault, train.drop_seed(cfg, seed))
        numbers = train.reference_train_numbers(
            prog, program.reference_weights(cfg, seed, device, parts=("gpt", "adapter")))
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          **dict(numbers), "seconds": time.perf_counter() - t0}), flush=True)
        del prog
        free_device(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
