"""VQGAN training step: a generator update, then a discriminator update (the
JAX package's `train/vq_step.py`).

Both optimizers are the port's AdamW (`make_optimizer(lr, beta1=0.9,
beta2=0.95)`: global-norm clipping at 1.0, weight decay on `decay_mask`).
The discriminator's update takes the reconstruction from before the
generator's update, and both updates see the state's step from before the
increment. The parameters are the modules' own, updated in place; the EMA
of the tokenizer's is optional.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.models.lpips import LPIPS
from controlar_tpu_torch.models.vq import VQModel
from controlar_tpu_torch.train import vq_loss as L
from controlar_tpu_torch.train.optimizer import AdamState, AdamW, Tensors, update_ema


@dataclasses.dataclass
class VQTrainState:
    step: int
    vq_params: Tensors       # the tokenizer's parameters (its modules' own)
    disc_params: Tensors     # the discriminator's
    vq_opt: AdamState
    disc_opt: AdamState
    ema_params: Optional[Tensors] = None


def init_vq_train_state(vq: VQModel, disc: nn.Module, tx_g: AdamW, tx_d: AdamW,
                        use_ema: bool = False) -> VQTrainState:
    """State over the modules' parameters, which are set to take gradients."""
    vq.requires_grad_(True)
    disc.requires_grad_(True)
    vq_params = dict(vq.named_parameters())
    disc_params = dict(disc.named_parameters())
    return VQTrainState(
        step=0, vq_params=vq_params, disc_params=disc_params,
        vq_opt=tx_g.init(vq_params), disc_opt=tx_d.init(disc_params),
        ema_params={n: p.detach().clone() for n, p in vq_params.items()} if use_ema else None)


def _grads(loss: torch.Tensor, params: Tensors) -> Tensors:
    """d loss / d params, zeros for the parameters the loss does not reach."""
    grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for (n, p), g in zip(params.items(), grads)}


def make_vq_train_step(
    cfg: VQConfig,
    tx_g: AdamW,
    tx_d: AdamW,
    lpips_net: LPIPS,
    disc_start: int = 20000,
    disc_weight: float = 0.5,
    rec_loss_type: str = "l2",
    ema_decay: Optional[float] = None,
    disc_type: str = "patchgan",
    disc_adaptive_weight: bool = False,
    disc_loss_type: str = "hinge",
):
    """-> train_step(vq, disc, state, images) -> (state, metrics); images
    (B, H, W, 3) in [-1, 1] on the modules' device."""

    def train_step(vq: VQModel, disc: nn.Module, state: VQTrainState,
                   images: torch.Tensor):
        gl, (metrics, recon) = L.generator_loss(
            vq, disc, lpips_net, cfg, images, state.step, disc_start, disc_weight,
            rec_loss_type=rec_loss_type, disc_type=disc_type,
            disc_adaptive_weight=disc_adaptive_weight)
        vq_opt, _ = tx_g.step(state.vq_params, _grads(gl, state.vq_params), state.vq_opt)
        recon = recon.detach()

        dl = L.discriminator_loss(disc, images, recon, state.step, disc_start, disc_weight,
                                  disc_loss_type=disc_loss_type, disc_type=disc_type)
        disc_opt, _ = tx_d.step(state.disc_params, _grads(dl, state.disc_params),
                                state.disc_opt)

        ema = state.ema_params
        if ema is not None and ema_decay is not None:
            ema = update_ema(ema, state.vq_params, ema_decay)
        out: Dict[str, torch.Tensor] = {k: v.detach() for k, v in metrics.items()}
        out.update(g_loss=gl.detach(), d_loss=dl.detach())
        return VQTrainState(state.step + 1, state.vq_params, state.disc_params, vq_opt,
                            disc_opt, ema), out

    return train_step
