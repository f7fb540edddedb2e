"""VQ tokenizer reconstruction evaluation (the JAX package's
`eval/reconstruction.py`): encode and decode images, PSNR and MS-SSIM per
image, and the PNG pairs and `samples.npz` that the FID tooling reads.
"""
from __future__ import annotations

import os
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from controlar_tpu_torch import check_on, resolve_device
from controlar_tpu_torch.config import VQConfig
from controlar_tpu_torch.eval.metrics import _ssim_pair, ms_ssim
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.pipeline import to_uint8_image


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 255.0) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


@torch.inference_mode()
def roundtrip(vq: vq_model.VQModel, cfg: VQConfig, x: torch.Tensor) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1] -> their reconstruction, no gradient."""
    z_q, _ = vq_model.encode(vq, cfg, x, device=x.device)
    return vq_model.decode(vq, cfg, z_q)


def reconstruction_eval(vq: vq_model.VQModel, cfg: VQConfig, batches: Iterable[np.ndarray],
                        out_dir: Optional[str] = None, device="cuda") -> Dict[str, float]:
    """batches: uint8 RGB (B, H, W, 3). -> mean PSNR, mean MS-SSIM (single-scale
    SSIM below 176 px, where the five scales do not fit) and the count; with
    out_dir, writes orig/{i}.png, recon/{i}.png and samples.npz (`arr_0`,
    uint8 NHWC reconstructions). Runs on `device`, where the model must be."""
    dev = resolve_device(device)
    check_on(vq, dev)
    psnrs, ssims, recons = [], [], []
    idx = 0
    for imgs in batches:
        x = torch.as_tensor(np.asarray(imgs), device=dev).float() / 127.5 - 1.0
        rec = to_uint8_image(roundtrip(vq, cfg, x))
        for a, b in zip(imgs, rec):
            psnrs.append(psnr(a, b))
            at = torch.as_tensor(a, device=dev).float()[None] / 255.0
            bt = torch.as_tensor(b, device=dev).float()[None] / 255.0
            if min(a.shape[:2]) >= 176:  # 5 MS-SSIM scales need >= 11 * 2**4
                s = ms_ssim(at, bt)
            else:
                s, _ = _ssim_pair(at.permute(0, 3, 1, 2), bt.permute(0, 3, 1, 2))
            ssims.append(float(s.reshape(-1)[0]))
            if out_dir:
                from PIL import Image

                os.makedirs(os.path.join(out_dir, "orig"), exist_ok=True)
                os.makedirs(os.path.join(out_dir, "recon"), exist_ok=True)
                Image.fromarray(np.asarray(a)).save(os.path.join(out_dir, "orig", f"{idx}.png"))
                Image.fromarray(b).save(os.path.join(out_dir, "recon", f"{idx}.png"))
            idx += 1
        if out_dir:
            recons.append(rec)
    if out_dir and recons:
        np.savez(os.path.join(out_dir, "samples.npz"), arr_0=np.concatenate(recons, axis=0))
    return {"psnr": float(np.mean(psnrs)), "ms_ssim": float(np.mean(ssims)), "count": idx}
