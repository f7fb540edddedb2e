"""VQGAN training losses (the JAX package's `train/vq_loss.py`).

Generator: reconstruction (l1 / l2) + LPIPS + the adversarial loss (held at
0 before `disc_start`, optionally scaled by the adaptive weight) + the
codebook losses (vq, commit, entropy). Discriminator: hinge, vanilla or
non-saturating on the images against the reconstruction.

The models are the port's modules, fp32; gradients are taken by the caller
(`train/vq_step.py`) with `torch.autograd.grad` on the trained modules'
parameters, so the frozen LPIPS network and, in the generator's loss, the
discriminator only pass the gradient on.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.models.discriminators import disc_forward
from controlar_tpu_torch.models.lpips import LPIPS, lpips
from controlar_tpu_torch.ops.conv import conv2d


# ---------------------------------------------------------------------------
# Quantizer losses
# ---------------------------------------------------------------------------

def quantize_with_losses(vq: vq_model.VQModel, cfg: VQConfig, z: torch.Tensor):
    """-> (z_q straight-through, indices, (vq_loss, commit_loss,
    entropy_loss)). The vq and commit losses are taken on the l2-normalised
    z (when codebook_l2_norm), the entropy loss on the affinity -d."""
    emb, zn, d = vq_model.code_distances(vq, cfg, z)
    indices = torch.argmin(d, dim=-1)
    z_q = emb[indices]
    vq_loss = torch.mean((z_q - zn.detach()) ** 2)
    commit_loss = cfg.commit_loss_beta * torch.mean((z_q.detach() - zn) ** 2)
    entropy_loss = torch.zeros((), device=z.device)
    if cfg.entropy_loss_ratio > 0:
        entropy_loss = cfg.entropy_loss_ratio * _entropy_loss(-d)
    z_q = zn + (z_q - zn).detach()
    return z_q, indices, (vq_loss, commit_loss, entropy_loss)


def _entropy_loss(affinity: torch.Tensor, temperature: float = 0.01) -> torch.Tensor:
    flat = affinity.reshape(-1, affinity.shape[-1]) / temperature
    probs = torch.softmax(flat, dim=-1)
    log_probs = torch.log_softmax(flat + 1e-5, dim=-1)
    avg_probs = probs.mean(dim=0)
    avg_entropy = -torch.sum(avg_probs * torch.log(avg_probs + 1e-5))
    sample_entropy = -torch.mean(torch.sum(probs * log_probs, dim=-1))
    return sample_entropy - avg_entropy


# ---------------------------------------------------------------------------
# GAN losses
# ---------------------------------------------------------------------------

def sigmoid_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax's sigmoid_binary_cross_entropy, elementwise."""
    return (torch.clamp(logits, min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def hinge_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.relu(1.0 - real)) + torch.mean(F.relu(1.0 + fake)))


def vanilla_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(F.softplus(-real)) + torch.mean(F.softplus(fake)))


def non_saturating_d_loss(real: torch.Tensor, fake: torch.Tensor) -> torch.Tensor:
    return 0.5 * (torch.mean(sigmoid_ce(real, torch.ones_like(real)))
                  + torch.mean(sigmoid_ce(fake, torch.zeros_like(fake))))


def hinge_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return -torch.mean(fake)


def non_saturating_gen_loss(fake: torch.Tensor) -> torch.Tensor:
    return torch.mean(sigmoid_ce(fake, torch.ones_like(fake)))


D_LOSSES = {"hinge": hinge_d_loss, "vanilla": vanilla_d_loss,
            "non-saturating": non_saturating_d_loss}
GEN_LOSSES = {"hinge": hinge_gen_loss, "non-saturating": non_saturating_gen_loss}


def adopt_weight(weight: float, global_step: int, threshold: int = 0,
                 value: float = 0.0) -> float:
    return value if global_step < threshold else weight


# ---------------------------------------------------------------------------
# Combined generator / discriminator objectives
# ---------------------------------------------------------------------------

def calculate_adaptive_weight(nll: torch.Tensor, gen_adv: torch.Tensor,
                              w_last: torch.Tensor) -> torch.Tensor:
    """The ratio of the gradient norms of the NLL (reconstruction +
    perceptual) and of the generator's adversarial loss with respect to the
    decoder's last weight alone, clipped to [0, 1e4] and detached. Each
    gradient is one backward through the losses to `w_last` (the graph is
    kept for the step's own backward)."""
    nll_g, = torch.autograd.grad(nll, w_last, retain_graph=True)
    adv_g, = torch.autograd.grad(gen_adv, w_last, retain_graph=True)
    d_weight = torch.linalg.vector_norm(nll_g) / (torch.linalg.vector_norm(adv_g) + 1e-4)
    return torch.clamp(d_weight, 0.0, 1e4).detach()


def generator_loss(
    vq: vq_model.VQModel,
    disc: nn.Module,
    lpips_net: LPIPS,
    cfg: VQConfig,
    images: torch.Tensor,          # (B, H, W, 3) in [-1, 1]
    global_step: int,
    disc_start: int,
    disc_weight: float = 0.5,
    rec_weight: float = 1.0,
    perceptual_weight: float = 1.0,
    rec_loss_type: str = "l2",
    gen_adv_loss_type: str = "hinge",
    disc_type: str = "patchgan",
    disc_adaptive_weight: bool = False,
) -> Tuple[torch.Tensor, Tuple[Dict[str, torch.Tensor], torch.Tensor]]:
    """-> (loss, (metrics, reconstruction)). The decoder runs through its
    trunk once; its last convolution is applied separately so that the
    adaptive weight differentiates with respect to that weight alone."""
    h = vq_model.encoder_forward(vq.encoder, cfg, images)
    h = conv2d(h, vq.quant_conv.weight, vq.quant_conv.bias)
    z_q, _, (vq_l, commit_l, ent_l) = quantize_with_losses(vq, cfg, h)
    zp = conv2d(z_q, vq.post_quant_conv.weight, vq.post_quant_conv.bias)
    trunk = vq_model.decoder_trunk(vq.decoder, cfg, zp)
    w_out = vq.decoder.conv_out.weight
    recon = conv2d(trunk, w_out, vq.decoder.conv_out.bias)

    if rec_loss_type == "l1":
        rec = torch.mean(torch.abs(images - recon))
    else:
        rec = torch.mean((images - recon) ** 2)
    p_loss = torch.mean(lpips(lpips_net, images, recon))
    gen_adv = GEN_LOSSES[gen_adv_loss_type](disc_forward(disc, disc_type, recon))

    if disc_adaptive_weight:
        adaptive = calculate_adaptive_weight(rec_weight * rec + perceptual_weight * p_loss,
                                             gen_adv, w_out)
    else:
        adaptive = torch.ones((), device=images.device)
    dw = adopt_weight(disc_weight, global_step, disc_start)

    loss = (rec_weight * rec + perceptual_weight * p_loss
            + adaptive * dw * gen_adv + vq_l + commit_l + ent_l)
    metrics = {"rec_loss": rec, "perceptual_loss": p_loss, "vq_loss": vq_l,
               "commit_loss": commit_l, "gen_adv_loss": gen_adv,
               "disc_adaptive_weight": adaptive}
    return loss, (metrics, recon)


def discriminator_loss(
    disc: nn.Module,
    images: torch.Tensor,
    recon: torch.Tensor,
    global_step: int,
    disc_start: int,
    disc_weight: float = 0.5,
    disc_loss_type: str = "hinge",
    disc_type: str = "patchgan",
) -> torch.Tensor:
    """Two separate forwards, the images' and the reconstruction's (both
    detached), so that PatchGAN's batch statistics are each batch's own."""
    logits_real = disc_forward(disc, disc_type, images.detach())
    logits_fake = disc_forward(disc, disc_type, recon.detach())
    return adopt_weight(disc_weight, global_step, disc_start) * D_LOSSES[disc_loss_type](
        logits_real, logits_fake)
