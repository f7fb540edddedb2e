"""Training checkpoints: the state saved with `torch.save`, one
`step_XXXXXXXX` directory per checkpoint, as the JAX package names them.

A checkpoint holds the step, the fp32 parameters, the optimizer's count and
moments and the EMA; restoring it into a state built the same way continues
the run bit for bit. Loading released GPT weights (`load_gpt_checkpoint`)
waits for checkpoints in the repository.
"""
from __future__ import annotations

import os
from typing import Optional

import torch

from controlar_tpu_torch.train.optimizer import AdamState
from controlar_tpu_torch.train.step import TrainState

_FILE = "state.pt"


def save_train_state(ckpt_dir: str, state: TrainState, step: Optional[int] = None) -> str:
    """Save the state under ckpt_dir/step_XXXXXXXX; returns that path."""
    step = state.step if step is None else step
    path = os.path.join(os.path.abspath(ckpt_dir), f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    opt = state.opt_state
    torch.save({
        "step": state.step,
        "params": {n: p.detach() for n, p in state.params.items()},
        "opt_count": opt.count, "mu": opt.mu, "nu": opt.nu,
        "ema_params": state.ema_params,
    }, os.path.join(path, _FILE))
    return path


@torch.no_grad()
def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a checkpoint into a state of the same structure: the parameters
    are copied into the state's tensors (the modules' own), the moments and
    EMA moved to their devices and dtypes."""
    saved = torch.load(os.path.join(path, _FILE), map_location="cpu", weights_only=True)
    if set(saved["params"]) != set(state.params):
        raise ValueError(f"{path}: parameters differ from the state's")
    for n, p in state.params.items():
        p.copy_(saved["params"][n])

    def like(src, ref):
        return {n: src[n].to(device=t.device, dtype=t.dtype) for n, t in ref.items()}

    opt = state.opt_state
    ema = None
    if state.ema_params is not None:
        ema = like(saved["ema_params"], state.ema_params)
    return TrainState(saved["step"], state.params,
                      AdamState(saved["opt_count"], like(saved["mu"], opt.mu),
                                like(saved["nu"], opt.nu)), ema)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def load_gpt_checkpoint(path: str, cfg):
    """Released GPT weights (the reference's .pt / .safetensors, or a native
    checkpoint) for `TrainerConfig.gpt_ckpt`."""
    raise NotImplementedError(
        "loading GPT checkpoints is not ported yet (no released checkpoint is in the "
        "repository to hold it to)")
