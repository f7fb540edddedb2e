"""ControlAR in PyTorch for NVIDIA Hopper.

A port of `controlar_tpu` (JAX) whose module names follow the JAX package's.
Its entry points run on the CUDA device unless the caller asks for the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; raises if a card is asked for and
    none is present (the port never moves to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def check_on(module: torch.nn.Module, device: torch.device) -> None:
    """Raise unless the module's parameters lie on `device`."""
    have = next(module.parameters()).device
    if have.type != device.type or device.index not in (None, have.index):
        raise ValueError(f"{type(module).__name__} is on {have}, expected {device}")
