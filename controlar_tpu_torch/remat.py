"""Activation checkpointing under the JAX package's remat policies.

`checkpointed(module, policy, *args)` runs one layer (a module whose
`forward` is the layer) under `torch.utils.checkpoint` (non-reentrant). The
selective policies use `create_selective_checkpoint_contexts`: they see the
operators the layer dispatches, which is why the flash training forward and
the `checkpoint_name` marker are custom operators (`ops/flash_train.py`).
"""
from __future__ import annotations

import functools

import torch
from torch import nn

from controlar_tpu_torch.ops import flash_train  # noqa: F401  (registers the operators)

# remat policies of the layer stack (the JAX package's names): "full"
# recomputes each layer in the backward; "qkv" saves the rotated q, k, v;
# "attn" the flash forward's (out, lse), so the backward never runs the
# forward kernel again; "qkv_attn" both; "dots" every matmul without batch
# dimensions; "none" saves everything.
REMAT_POLICIES = ("full", "qkv", "attn", "qkv_attn", "dots", "none")


def _remat_context(policy: str):
    """The context_fn of torch.utils.checkpoint for a selective policy."""
    from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

    saved = {"qkv": {"qkv"}, "attn": {"attn"}, "qkv_attn": {"qkv", "attn"},
             "dots": {"dots"}}[policy]
    ops = torch.ops.controlar_torch
    dots = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)

    def policy_fn(ctx, op, *args, **kwargs):
        if op is ops.flash_train_fwd.default:
            save = "attn" in saved
        elif op is ops.checkpoint_name.default:
            save = args[1] in saved
        else:
            save = "dots" in saved and op in dots
        return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def checkpointed(module: nn.Module, remat: str, *args, **kwargs):
    """module(*args, **kwargs) under the remat policy: "none" runs it as it
    is; otherwise it runs under torch.utils.checkpoint (non-reentrant), with
    the module's current parameter tensors passed in explicitly and bound by
    `torch.func.functional_call`, so that a recompute in the backward reads
    the tensors of the forward (the bf16 copies of a bf16 step)."""
    if remat == "none":
        return module(*args, **kwargs)
    if remat not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {remat!r}; options: {REMAT_POLICIES}")
    from torch.utils.checkpoint import checkpoint

    def run(params, *a):
        return torch.func.functional_call(module, params, a, kwargs)

    extra = {} if remat == "full" else {"context_fn": _remat_context(remat)}
    return checkpoint(run, dict(module.named_parameters()), *args, use_reentrant=False,
                      preserve_rng_state=False, **extra)
