"""AdamW with the reference's weight-decay split, global-norm clipping, EMA.

The JAX package's `train/optimizer.py` chains optax's
`clip_by_global_norm(max_grad_norm)` and `adamw(b1, b2, eps=1e-8,
weight_decay, mask=decay_mask)`; `AdamW.step` computes the same update with
the same expressions in fp32, over dicts of named tensors (the names of
`named_parameters()`):

  g      <- g if |g| < max_norm else (g / |g|) * max_norm   (|g| over all
            gradients, the frozen zeros included)
  mu     <- (1 - b1) g + b1 mu;   nu <- (1 - b2) g^2 + b2 nu;   count += 1
  u      <- (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
  u      <- u + wd p             (decayed parameters only)
  p      <- p + (-lr) u

With `state_dtype=torch.bfloat16` the moments are stored in bf16 and the
update runs in fp32 on the moments cast up (`with_state_dtype`). The
parameters are updated in place.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, Optional

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]

# the reference decays only parameters of two or more dimensions; its norm
# weights are 1-D, and the caption embedder's unconditional embedding is a
# buffer, never optimized
_NO_DECAY_KEYS = {"attention_norm", "ffn_norm", "norm", "uncond_embedding"}
_FROZEN_KEYS = {"uncond_embedding"}
# the JAX package stacks per-layer tensors on a leading layer axis and takes
# the rule on the stacked shape; that axis counts for tensors under `layers.<l>.`
_PER_LAYER = re.compile(r"(^|\.)layers\.\d+\.")


def _leaf_key(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def decay_mask(params: Tensors) -> Dict[str, bool]:
    """True for the parameters that receive weight decay."""
    return {n: p.dim() + bool(_PER_LAYER.search(n)) >= 2 and _leaf_key(n) not in _NO_DECAY_KEYS
            for n, p in params.items()}


def frozen_mask(params: Tensors) -> Dict[str, bool]:
    """True for the parameters that are never updated (reference buffers)."""
    return {n: _leaf_key(n) in _FROZEN_KEYS for n in params}


def zero_frozen_grads(grads: Dict[str, Optional[torch.Tensor]], params: Tensors) -> Tensors:
    """The gradients with zeros for frozen parameters and for parameters the
    loss did not reach."""
    frozen = frozen_mask(params)
    return {n: torch.zeros_like(p) if frozen[n] or grads.get(n) is None else grads[n]
            for n, p in params.items()}


def step_lr(lr: float, decay_every_steps: int, gamma: float = 0.9) -> Schedule:
    """torch StepLR: lr * gamma ** (count // decay_every_steps)."""
    return lambda count: lr * gamma ** (count // decay_every_steps)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a dict or a list), an
    fp32 scalar: per-tensor norms in a few multi-tensor launches, then their
    norm (the same value as one sum of squares, to fp32 rounding)."""
    if isinstance(tensors, dict):
        tensors = list(tensors.values())
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Tensors
    nu: Tensors


@dataclasses.dataclass
class AdamW:
    lr: float = 1e-4
    weight_decay: float = 5e-2
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    lr_schedule: Optional[Schedule] = None
    state_dtype: Optional[torch.dtype] = None  # None = the parameters' (fp32)

    def init(self, params: Tensors) -> AdamState:
        def zeros(p):
            return torch.zeros_like(p, dtype=self.state_dtype or p.dtype)

        return AdamState(0, {n: zeros(p) for n, p in params.items()},
                         {n: zeros(p) for n, p in params.items()})

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: AdamState):
        """Clip, update the moments and the parameters; -> (new state, the
        gradients' global norm before clipping). grads holds a tensor for
        every parameter. The parameters, the gradients and (fp32) moments
        are updated in place. After the global norm, the update runs over
        groups of at most CHUNK_ELEMENTS elements, so its fp32 temporaries
        stay a bounded size whatever the model's (each value is the same as
        in one pass: every operation is elementwise)."""
        names = list(params)
        norm = global_norm([grads[n].float() for n in names])
        # g * keep + (g / norm * max) * (1 - keep) with keep 0 or 1 selects
        # exactly, without a host sync on the norm
        keep = (norm < self.max_grad_norm).float()
        count = state.count + 1
        bc1 = float(np.float32(1) - np.float32(self.beta1) ** np.int32(count))
        bc2 = float(np.float32(1) - np.float32(self.beta2) ** np.int32(count))
        lr = self.lr_schedule(state.count) if self.lr_schedule is not None else self.lr
        decay = decay_mask(params) if self.weight_decay else {}
        dtype = self.state_dtype
        new_mu, new_nu = {}, {}
        for group in _groups(params, CHUNK_ELEMENTS):
            p = [params[n] for n in group]
            g = [grads[n].float() for n in group]
            clipped = torch._foreach_div(g, norm)
            torch._foreach_mul_(clipped, self.max_grad_norm)
            torch._foreach_mul_(clipped, 1.0 - keep)
            torch._foreach_mul_(g, keep)
            torch._foreach_add_(g, clipped)
            del clipped
            mu = [state.mu[n].float() for n in group]
            nu = [state.nu[n].float() for n in group]
            torch._foreach_mul_(mu, self.beta1)
            torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - self.beta1))
            torch._foreach_mul_(nu, self.beta2)
            torch._foreach_mul_(g, g)
            torch._foreach_mul_(g, 1.0 - self.beta2)
            torch._foreach_add_(nu, g)
            del g
            upd = torch._foreach_div(mu, bc1)
            denom = torch._foreach_div(nu, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)
            del denom
            idx = [i for i, n in enumerate(group) if decay.get(n)]
            if idx:
                torch._foreach_add_([upd[i] for i in idx],
                                    torch._foreach_mul([p[i] for i in idx], self.weight_decay))
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(p, upd)
            del upd
            for n, m, v in zip(group, mu, nu):
                new_mu[n], new_nu[n] = m.to(dtype or m.dtype), v.to(dtype or v.dtype)
        return AdamState(count, new_mu, new_nu), norm


# the elements an AdamW group updates at once: 1 GiB of fp32 per temporary
CHUNK_ELEMENTS = 1 << 28


def _groups(params: Tensors, limit: int):
    """The names in order, in runs of at most `limit` elements (a larger
    tensor alone)."""
    group, size = [], 0
    for n, t in params.items():
        if group and size + t.numel() > limit:
            yield group
            group, size = [], 0
        group.append(n)
        size += t.numel()
    if group:
        yield group


def make_optimizer(lr: float = 1e-4, weight_decay: float = 5e-2, beta1: float = 0.9,
                   beta2: float = 0.95, max_grad_norm: float = 1.0,
                   lr_schedule: Optional[Schedule] = None,
                   state_dtype: Optional[str] = None) -> AdamW:
    """AdamW as the JAX package's `make_optimizer` builds it; state_dtype
    "bfloat16" stores the moments in bf16 (`with_state_dtype`)."""
    return with_state_dtype(AdamW(lr=lr, weight_decay=weight_decay, beta1=beta1, beta2=beta2,
                                  max_grad_norm=max_grad_norm, lr_schedule=lr_schedule),
                            state_dtype)


def with_state_dtype(tx: AdamW, dtype) -> AdamW:
    """Store Adam's moments in `dtype` ("bfloat16" or a torch dtype; fp32
    keeps them as they are); the update still runs in fp32."""
    if dtype is None:
        return tx
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return dataclasses.replace(tx, state_dtype=None if dtype == torch.float32 else dtype)


@torch.no_grad()
def update_ema(ema: Tensors, params: Tensors, decay: float = 0.9999) -> Tensors:
    """EMA of the parameters: decay * e + (1 - decay) * p."""
    names = list(ema)
    new = torch._foreach_add(torch._foreach_mul([ema[n] for n in names], decay),
                             torch._foreach_mul([params[n] for n in names], 1.0 - decay))
    return dict(zip(names, new))
