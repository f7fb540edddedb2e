"""What every traffic loop shares. A loop is a module of its own,
`portbench/loops/<name>.py`, named by a traffic file's "loop" key and found
by that name (`manifest.Manifest.loop`); it defines `Loop`, a subclass of
`Base` here, which builds the program in `setup`, times `window(seconds)`,
profiles a short `trace_slice`, lets the program go in `free`, and in
`check` compares what the window produced with the reference. The facts it
hands the metric readers are plain dicts (`window`, `slice`).
"""
from __future__ import annotations

import gc
import math

import numpy as np
import torch

from portbench.reference import canny as ref_canny
from portbench.reference import vit as ref_vit


class WindowEnd(Exception):
    """Raised from a decode step's hook when the window has closed."""


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free_device(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def reference_features(p_vit: dict, cfg: dict, images_u8: np.ndarray, device) -> torch.Tensor:
    """The reference's control features of raw images: Canny, the adapter."""
    c = cfg["canny"]
    out = []
    for blk in np.array_split(images_u8, max(1, math.ceil(len(images_u8) / 8))):
        edges = ref_canny.canny(torch.as_tensor(blk, device=device), c["low"], c["high"],
                                c["hysteresis_rings"])
        out.append(ref_vit.forward(p_vit, cfg["adapter"], ref_vit.condition_input(edges)))
    return torch.cat(out)


class Base:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: torch.device,
                 trace: bool, control: bool = False):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.trace, self.control = trace, control
        self.g = cfg["gpt"]
