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

import collections
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
    def step(self, params: Tensors, grads: Tensors, state: AdamState,
             norm: Optional[torch.Tensor] = None):
        """Clip, update the moments and the parameters; -> (new state, the
        gradients' global norm before clipping). grads holds a tensor for
        every parameter. The parameters, the gradients and (fp32) moments
        are updated in place. After the global norm, the update runs over
        groups of at most CHUNK_ELEMENTS elements, so its fp32 temporaries
        stay a bounded size whatever the model's (each value is the same as
        in one pass: every operation is elementwise). `norm`, when given, is
        the global norm to clip by: a sharded model's (the pieces here are
        this rank's, `parallel.sharding.ShardLayout.global_norm`)."""
        names = list(params)
        if norm is None:
            norm = global_norm([grads[n].float() for n in names])
        # g * keep + (g / norm * max) * (1 - keep) with keep 0 or 1 selects
        # exactly, without a host sync on the norm; the unselected quotient
        # divides by one when the norm is below the limit (zero gradients, a
        # loss held at zero, would make it 0 / 0, and NaN * 0 is NaN)
        keep = (norm < self.max_grad_norm).float()
        div = torch.where(keep > 0, torch.ones_like(norm), norm)
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
            clipped = torch._foreach_div(g, div)
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


# ---------------------------------------------------------------------------
# Adafactor: optax.chain(clip_by_global_norm(1.0), adafactor(lr)) at optax
# 0.2.6's defaults, the JAX package's toy training optimizer
# (scripts/toy_train_quant.py)
# ---------------------------------------------------------------------------

# the JAX package stacks a model's per-layer tensors on a leading axis (the
# transformer's `layers`, the GPT's `condition_layers`): optax's block RMS is
# taken over the whole stacked leaf, so over every layer's tensor together
_STACKED = re.compile(r"(^|\.)(layers|condition_layers)\.\d+\.")


def jax_leaf(name: str) -> str:
    """The JAX package's leaf a port parameter belongs to: the name with its
    layer index replaced by `*` where the JAX package stacks the layers."""
    return _STACKED.sub(r"\1\2.*.", name, count=1)


def _factored_dims(shape, min_dim: int):
    """optax's rule: factor over the two largest dimensions when the second
    largest is at least min_dim -> (d1, d0) = (second largest, largest)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    if shape[order[-2]] < min_dim:
        return None
    return int(order[-2]), int(order[-1])


@dataclasses.dataclass
class AdafactorState:
    count: int
    v_row: Tensors  # factored tensors: the second largest dimension's statistics
    v_col: Tensors  # ... and the largest's
    v: Tensors      # the other tensors' second moments


# optax 0.2.6's adafactor defaults, and the chain's global-norm clip
AF_MAX_GRAD_NORM = 1.0
AF_DECAY_RATE = 0.8
AF_MIN_DIM_SIZE_TO_FACTOR = 128
AF_EPS = 1e-30
AF_CLIPPING_THRESHOLD = 1.0
AF_MIN_SCALE = 1e-3


@dataclasses.dataclass
class Adafactor:
    """Per update, in fp32 (the state too), with the AF_* constants:

      g    <- global-norm clip at AF_MAX_GRAD_NORM (as AdamW's)
      beta <- 1 - (count + 1)^-AF_DECAY_RATE
      factored (two dimensions >= AF_MIN_DIM_SIZE_TO_FACTOR; d0 the largest,
      d1 the second): R <- beta R + (1 - beta) mean_d0(g^2 + AF_EPS),
      C <- beta C + (1 - beta) mean_d1(g^2 + AF_EPS), u = g (R / mean(R))^-1/2 C^-1/2;
      else V <- beta V + (1 - beta)(g^2 + AF_EPS), u = g V^-1/2
      u <- u / max(1, rms(u) / AF_CLIPPING_THRESHOLD)     (block RMS)
      p <- p - lr max(rms(p), AF_MIN_SCALE) u              (parameter scale)

    The factoring of a tensor stacked in the JAX package is per layer, as
    there (its two largest dimensions are the layer's), and transposing a
    tensor leaves the update unchanged; both RMS values are taken over the
    JAX package's whole leaf (`jax_leaf`). The parameters are updated in
    place."""
    lr: float = 1e-3

    @staticmethod
    def _dims(name: str, p: torch.Tensor, layers: int):
        """The factored dimensions of a tensor; a stacked leaf with as many
        layers as AF_MIN_DIM_SIZE_TO_FACTOR could factor over the layer
        axis, which a per-layer tensor cannot."""
        if layers >= AF_MIN_DIM_SIZE_TO_FACTOR:
            raise NotImplementedError(f"{jax_leaf(name)}: {layers} stacked layers, which "
                                      f"optax could factor over the layer axis")
        return _factored_dims(tuple(p.shape), AF_MIN_DIM_SIZE_TO_FACTOR)

    def init(self, params: Tensors) -> AdafactorState:
        layers = collections.Counter(jax_leaf(n) for n in params)
        v_row, v_col, v = {}, {}, {}
        for n, p in params.items():
            dims = self._dims(n, p, layers[jax_leaf(n)] if jax_leaf(n) != n else 1)
            if dims is None:
                v[n] = torch.zeros_like(p, dtype=torch.float32)
            else:
                d1, d0 = dims
                shape = list(p.shape)
                v_row[n] = p.new_zeros(shape[:d0] + shape[d0 + 1:], dtype=torch.float32)
                v_col[n] = p.new_zeros(shape[:d1] + shape[d1 + 1:], dtype=torch.float32)
        return AdafactorState(0, v_row, v_col, v)

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: AdafactorState):
        """-> (new state, the gradients' global norm before clipping)."""
        norm = global_norm([grads[n] for n in params])
        keep = norm < AF_MAX_GRAD_NORM
        beta = float(np.float32(1) - np.float32(state.count + 1) ** np.float32(-AF_DECAY_RATE))
        v_row, v_col, v = dict(state.v_row), dict(state.v_col), dict(state.v)
        leaves = collections.defaultdict(list)
        for n in params:
            leaves[jax_leaf(n)].append(n)
        for group in leaves.values():
            us = []
            for n in group:
                g = grads[n].float()
                g = torch.where(keep, g, g / norm * AF_MAX_GRAD_NORM)
                g2 = g * g + AF_EPS
                if n in v:
                    v[n] = beta * v[n] + (1.0 - beta) * g2
                    us.append(g * v[n] ** -0.5)
                    continue
                d1, d0 = _factored_dims(tuple(g.shape), AF_MIN_DIM_SIZE_TO_FACTOR)
                v_row[n] = beta * v_row[n] + (1.0 - beta) * g2.mean(dim=d0)
                v_col[n] = beta * v_col[n] + (1.0 - beta) * g2.mean(dim=d1)
                del g2
                row_col_mean = v_row[n].mean(dim=d1 - 1 if d1 > d0 else d1, keepdim=True)
                row = (v_row[n] / row_col_mean) ** -0.5
                us.append(g * row.unsqueeze(d0) * (v_col[n] ** -0.5).unsqueeze(d1))
            numel = sum(u.numel() for u in us)
            u_rms = torch.sqrt(torch.stack([(u * u).sum() for u in us]).sum() / numel)
            denom = torch.clamp(u_rms / AF_CLIPPING_THRESHOLD, min=1.0)
            p_rms = torch.sqrt(torch.stack([(params[n].float() ** 2).sum() for n in group]).sum()
                               / numel)
            p_scale = torch.where(p_rms <= AF_MIN_SCALE, AF_MIN_SCALE, p_rms)
            for n, u in zip(group, us):
                params[n].add_((u / denom * self.lr * p_scale * -1.0).to(params[n].dtype))
        return AdafactorState(state.count + 1, v_row, v_col, v), norm


@torch.no_grad()
def update_ema(ema: Tensors, params: Tensors, decay: float = 0.9999) -> Tensors:
    """EMA of the parameters: decay * e + (1 - decay) * p."""
    names = list(ema)
    new = torch._foreach_add(torch._foreach_mul([ema[n] for n in names], decay),
                             torch._foreach_mul([params[n] for n in names], 1.0 - decay))
    return dict(zip(names, new))
