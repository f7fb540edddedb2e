"""Comparison continuous-latent autoencoders: SD-VAE and the OpenAI
consistency decoder (the JAX package's `models/latent_vae.py`).

The reference's comparison scripts are thin wrappers over diffusers models
(`AutoencoderKL`, `ConsistencyDecoderVAE`), so the surface here is the
same: load the diffusers model from a local directory, expose
`reconstruct(images_u8) -> images_u8` with the reference's pre- and
post-processing (x / 127.5 - 1, encode, mode or sample, decode, clamp,
round to uint8), for eval/reconstruction.py's rFID / PSNR / SSIM. diffusers
is imported inside the functions; without it they raise an ImportError
that names the package.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from controlar_tpu_torch import resolve_device


def _require_diffusers():
    try:
        import diffusers  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the SD-VAE / consistency-decoder comparison tokenizers need the "
            "`diffusers` package, which is not installed; the first-party "
            "tokenizers (models/vq.py, models/taming_vqgan.py) cover the "
            "framework's own paths"
        ) from e


def sd_vae_reconstructor(model_dir: str, device="cuda",
                         sample_posterior: bool = False
                         ) -> Callable[[np.ndarray], np.ndarray]:
    """AutoencoderKL round trip (ref reconstruction_vae_ddp.py protocol:
    encode -> (mode|sample) latent -> decode), on `device` ('cuda' unless
    the caller asks for 'cpu')."""
    _require_diffusers()
    device = resolve_device(device)
    import torch
    from diffusers.models import AutoencoderKL

    vae = AutoencoderKL.from_pretrained(model_dir).to(device).eval()

    def reconstruct(images_u8: np.ndarray) -> np.ndarray:
        x = np.asarray(images_u8, np.float32) / 127.5 - 1.0
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).to(device)
        with torch.no_grad():
            post = vae.encode(xt).latent_dist
            z = post.sample() if sample_posterior else post.mode()
            rec = vae.decode(z).sample
        rec = rec.clamp(-1, 1).cpu().numpy().transpose(0, 2, 3, 1)
        return ((rec + 1) * 127.5).round().astype(np.uint8)

    return reconstruct


def consistency_decoder_reconstructor(model_dir: str, device="cuda"
                                      ) -> Callable[[np.ndarray], np.ndarray]:
    """ConsistencyDecoderVAE round trip (ref reconstruction_cd_ddp.py)."""
    _require_diffusers()
    device = resolve_device(device)
    import torch
    from diffusers.models import ConsistencyDecoderVAE

    vae = ConsistencyDecoderVAE.from_pretrained(model_dir).to(device).eval()

    def reconstruct(images_u8: np.ndarray) -> np.ndarray:
        x = np.asarray(images_u8, np.float32) / 127.5 - 1.0
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2)).to(device)
        with torch.no_grad():
            z = vae.encode(xt).latent_dist.mode()
            rec = vae.decode(z).sample
        rec = rec.clamp(-1, 1).cpu().numpy().transpose(0, 2, 3, 1)
        return ((rec + 1) * 127.5).round().astype(np.uint8)

    return reconstruct
