"""The train step for c2i/t2i control fine-tuning (the JAX package's
`train/step.py`), here with precomputed adapter features.

One step: bf16 forward (the fp32 master parameters cast to bf16 at use,
`_cast_bf16`, bound to the modules with `torch.func.functional_call`, so the
gradients land on the masters), the CE loss with `valid`, caption and
condition CFG dropout sharing drop_ids, gradients of every parameter (the
frozen ones zero), global-norm clip, AdamW, optional EMA.

Randomness comes from integer keys: the step's key is (seed, step), its
class dropout draws from (seed, step, 0) and the model's dropout from
(seed, step, 1, ...) (`models/gpt.generator`), so a step is a function of
the state, the batch and the seed, as `jax.random.fold_in(rng, step)` makes
it in the JAX package (which draws other numbers). Over a mesh
(`parallel.sharding.ShardLayout`) the state holds this rank's pieces, and a
data-parallel replica's key is (seed, step, replica) when there are
several: each replica draws its own rows' dropout.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.spans import span
from controlar_tpu_torch.train.optimizer import (
    AdamState,
    AdamW,
    Tensors,
    update_ema,
    zero_frozen_grads,
)


@dataclasses.dataclass
class TrainState:
    step: int
    params: Tensors  # the fp32 masters, the modules' own parameters
    opt_state: AdamState
    ema_params: Optional[Tensors] = None


def init_train_state(model: nn.Module, tx: AdamW, use_ema: bool = False) -> TrainState:
    """State over the module's parameters, which stay the module's."""
    params = dict(model.named_parameters())
    return TrainState(step=0, params=params, opt_state=tx.init(params),
                      ema_params={n: p.detach().clone() for n, p in params.items()}
                      if use_ema else None)


def _cast_bf16(params: Tensors) -> Tensors:
    """fp32 tensors cast to bf16 (differentiable: gradients reach the fp32
    masters in fp32), others as they are."""
    return {n: p.to(torch.bfloat16) if p.dtype == torch.float32 else p for n, p in params.items()}


def drop_ids(cfg: GPTConfig, b: int, key, device) -> torch.Tensor:
    """(B,) bool: the samples whose caption / class and condition are
    dropped for CFG, uniform < class_dropout_prob."""
    u = torch.rand(b, generator=gpt_model.generator(key, device), device=device)
    return u < cfg.class_dropout_prob


def prefix_embedding(gpt: gpt_model.GPT, cfg: GPTConfig, batch: Dict[str, torch.Tensor],
                     dropped: torch.Tensor, compute_dtype) -> torch.Tensor:
    """The class (c2i) or caption (t2i) prefix, dropped rows replaced by the
    null class or the unconditional caption. Labels are (B,), or (B, 1) from
    a .car file, which stores a sample's 0-d label as shape (1,)."""
    if cfg.model_type == "c2i":
        labels = torch.where(dropped, cfg.num_classes, batch["labels"].long().reshape(-1))
        return gpt_model.embed_prefix_c2i(gpt, labels)
    cap = batch["caption_emb"].to(compute_dtype)
    uncond = gpt.cls_embedding.uncond_embedding.to(compute_dtype)
    cap = torch.where(dropped[:, None, None], uncond[None, : cap.shape[1]], cap)
    return gpt_model.embed_prefix_t2i(gpt, cap)[:, : cfg.cls_token_num]


class _Loss(nn.Module):
    """Binds a loss function to a module for `torch.func.functional_call`:
    the call runs fn() while the module holds the given tensors."""

    def __init__(self, model: nn.Module, fn: Callable[[], torch.Tensor]):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self):
        return self.fn()


def make_train_step(cfg: GPTConfig, tx: AdamW, ema_decay: Optional[float] = None,
                    compute_dtype=torch.bfloat16, remat_policy: str = "full"):
    """-> train_step(model, state, batch, seed) -> (state, metrics).

    Batch: tokens (B, block_size); c2i labels (B,) or t2i caption_emb (B,
    T_cls, caption_dim); adapter_features (B, block_size, adapter_dim) or
    absent; attn_mask (B, 1, T, T) bool (einsum) or key_valid (B, T) bool
    (flash) or absent; valid (B,) or absent."""

    def loss_fn(gpt, batch, key):
        tokens = batch["tokens"].long()
        dropped = drop_ids(cfg, tokens.shape[0], (*key, 0), tokens.device)
        prefix = prefix_embedding(gpt, cfg, batch, dropped, compute_dtype)
        cond = None
        if "adapter_features" in batch:
            cond = gpt_model.control_tokens(gpt, cfg, batch["adapter_features"].to(compute_dtype),
                                            dropped)
        _, loss = gpt_model.forward_train(
            gpt, cfg, prefix.to(compute_dtype), tokens[:, :-1], cond_tokens=cond,
            mask=batch.get("attn_mask"), key_valid=batch.get("key_valid"), targets=tokens,
            valid=batch.get("valid"), rng=(*key, 1), deterministic=False,
            remat_policy=remat_policy)
        return loss

    def train_step(gpt: gpt_model.GPT, state: TrainState, batch: Dict[str, torch.Tensor],
                   seed: int):
        key = (seed, state.step)
        wrapper = _Loss(gpt, lambda: loss_fn(gpt, batch, key))
        return apply_step(wrapper, "model.", state, tx, compute_dtype, ema_decay)

    return train_step


def step_key(seed: int, step: int, layout=None) -> tuple:
    """(seed, step), and the data-parallel replica when there are several."""
    if layout is not None and layout.mesh.size("dp") > 1:
        return (seed, step, layout.mesh.index("dp"))
    return (seed, step)


def loss_weight(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The weight of a batch in the mean loss: its `valid` sum, else its
    rows (the loss is a mean over samples and tokens, every sample the same
    tokens)."""
    if "valid" in batch:
        return batch["valid"].float().sum()
    return torch.tensor(float(batch["tokens"].shape[0]))


def apply_step(wrapper: nn.Module, prefix: str, state: TrainState, tx: AdamW,
               compute_dtype, ema_decay: Optional[float], layout=None,
               weight: Optional[torch.Tensor] = None):
    """One optimizer step: the loss is wrapper() with the module holding the
    state's parameters (named with `prefix` in front) in the compute dtype;
    gradients of the trainable masters (zeros for the frozen ones), AdamW,
    EMA. -> (new state, metrics {loss, grad_norm}).

    With a `parallel.sharding.ShardLayout` the state holds this rank's
    pieces: the compute copies are gathered whole, the gradients (scaled by
    this rank's share of the batch's loss `weight`) summed over the
    data-parallel ranks into the pieces, and clipped by the whole model's
    norm; the loss is the mean over the whole batch.

    The phases are the profiler spans `train.forward` (the compute copies
    through the loss), `train.backward` (the gradients, remat's recompute
    and the reduction over the mesh) and `train.update` (`spans.span`)."""
    params = state.params
    trainable = [n for n, p in params.items() if p.requires_grad]
    with span("train.forward"):
        if layout is None:
            bound = _cast_bf16(params) if compute_dtype == torch.bfloat16 else dict(params)
            wrt = [params[n] for n in trainable]
        else:
            bound = layout.gather_params(params, compute_dtype)
            wrt = [bound[n] for n in trainable]
        loss = torch.func.functional_call(wrapper, {prefix + n: t for n, t in bound.items()}, ())
    with span("train.backward"):
        grads = dict(zip(trainable, torch.autograd.grad(loss, wrt, allow_unused=True)))
        if layout is not None:
            share = layout.loss_share(weight.to(loss.device))
            grads = layout.reduce_grads({n: g if g is not None else torch.zeros_like(bound[n])
                                         for n, g in grads.items()}, share)
            loss = layout.dp_sum(loss * share)
    with span("train.update"):
        grads = zero_frozen_grads(grads, params)
        if layout is None:
            opt_state, grad_norm = tx.step(params, grads, state.opt_state)
        else:  # AdamW: its moments are elementwise, so it updates the pieces as they are
            opt_state, grad_norm = tx.step(params, grads, state.opt_state,
                                           norm=layout.global_norm(grads))
        ema = state.ema_params
        if ema is not None and ema_decay is not None:
            ema = update_ema(ema, params, ema_decay)
    metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
    return TrainState(state.step + 1, params, opt_state, ema), metrics
