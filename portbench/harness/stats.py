"""The arithmetic the metric readers share: the idle share of a slice,
roofline shares and MFU. Each returns None where the
cell has nothing for it to read, never 0 for a share of a peak."""
from __future__ import annotations

from typing import Optional

from portbench.harness import roofline as rl
from portbench.harness.trace import kernel_launches, kernel_time

DECODE_KERNEL = "flash_decode_kernel"
TRAIN_KERNELS = {"fwd": "flash_train_fwd", "dq": "flash_train_dq", "dkv": "flash_train_dkv"}


def idle_share(ctx, kind: str) -> Optional[float]:
    s = ctx.slice
    if not s or s.get("kind") != kind or s["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"])


def decode_roofline(ctx, kind: str) -> Optional[float]:
    """Every launch of the slice: n_layer a decode step, each over all rows
    at that step's positions."""
    s, g = ctx.slice, ctx.cfg["gpt"]
    if not s or s.get("kind") != kind:
        return None
    t = kernel_time(s, DECODE_KERNEL)
    steps = s["live_rows"]
    if t <= 0 or kernel_launches(s, DECODE_KERNEL) != len(steps) * g["n_layer"]:
        return None
    least = sum(g["n_layer"] * rl.decode_bound([pos] * s["rows"], g["n_head"], g["head_dim"],
                                              s["bias"]) for pos in steps)
    return 100.0 * least / t


def train_roofline(ctx) -> Optional[float]:
    s, g = ctx.slice, ctx.cfg["gpt"]
    if not s or s.get("kind") != "train":
        return None
    least = total = 0.0
    for kind, frag in TRAIN_KERNELS.items():
        n = kernel_launches(s, frag)
        least += n * rl.train_bound(kind, s["batch"], s["t"], g["n_head"], g["head_dim"],
                                    s["bias"])
        total += kernel_time(s, frag)
    return 100.0 * least / total if total > 0 and least > 0 else None


def mfu(ctx, kind: str) -> Optional[float]:
    w, cfg = ctx.window, ctx.cfg
    g = cfg["gpt"]
    if w.get("kind") != kind:
        return None
    cls = g["cls_token_num"]
    if kind == "gen":
        flops = sum(rl.decode_flops(g, 2 * w["batch"], range(cls + c["tokens_per_row"] - 1))
                    for c in w["calls"])
    else:
        flops = w["steps"] * rl.palm_flops(g, cfg["adapter"], cfg["image_px"], w["batch"])
    return 100.0 * flops / w["seconds"] / rl.BF16_FLOPS if flops > 0 else None
