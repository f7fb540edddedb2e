"""VQGAN tokenizer training over an image folder, then the reconstruction
evaluation; and the evaluation of a checkpoint alone (the JAX package's CLI
commands `train-vq` and `eval-vq`).

    python -m controlar_tpu_torch.train.vq_train --images DIR [--vq-model VQ-16]
        [--image-size 256] [--batch-size 16] [--lr 1e-4] [--max-steps 100000]
        [--disc-start 20000] [--disc-type patchgan|stylegan]
        [--disc-loss hinge|vanilla|non-saturating] [--disc-adaptive-weight]
        [--lpips-vgg FILE --lpips-lin FILE] [--ema] [--log-every 100]
        [--ckpt-every 5000] [--eval-after 64] [--results-dir results] [--seed 0]
    python -m controlar_tpu_torch.train.vq_train eval-vq --images DIR
        [--vq-ckpt PATH] [--image-size 256] [--batch-size 8] [--output-dir DIR]

Both run on the card. Batches are center crops (`data/augmentation.
center_crop_arr`) of files drawn with a numpy generator seeded with --seed.
Checkpoints go to results/vq_checkpoints/step_XXXXXXXX
(`checkpoint.save_vq_train_state`), which `checkpoint.load_vq_checkpoint`
reads (the EMA first). Without --lpips-vgg / --lpips-lin the LPIPS network
has random weights from the seed.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from controlar_tpu_torch import checkpoint as ckpt_lib
from controlar_tpu_torch import convert_ref, resolve_device
from controlar_tpu_torch.config import vq_config
from controlar_tpu_torch.data.augmentation import center_crop_arr
from controlar_tpu_torch.eval.reconstruction import reconstruction_eval
from controlar_tpu_torch.models import vq as vq_model
from controlar_tpu_torch.models.discriminators import init_patchgan, init_stylegan_disc
from controlar_tpu_torch.models.lpips import init_lpips
from controlar_tpu_torch.train.optimizer import make_optimizer
from controlar_tpu_torch.train.vq_step import init_vq_train_state, make_vq_train_step

_IMAGE_EXT = (".png", ".jpg", ".jpeg")


def image_files(folder: str) -> List[str]:
    return sorted(f for f in os.listdir(folder) if f.lower().endswith(_IMAGE_EXT))


def load_crop(folder: str, name: str, image_size: int) -> np.ndarray:
    """One image as a uint8 (image_size, image_size, 3) center crop."""
    from PIL import Image

    with Image.open(os.path.join(folder, name)) as im:
        return np.asarray(center_crop_arr(im.convert("RGB"), image_size), np.uint8)


def uint8_batches(folder: str, files: List[str], image_size: int,
                  batch_size: int) -> Iterator[np.ndarray]:
    for i in range(0, len(files), batch_size):
        yield np.stack([load_crop(folder, f, image_size) for f in files[i:i + batch_size]])


def train_vq(images: str, vq_model_name: str = "VQ-16", image_size: int = 256,
             batch_size: int = 16, lr: float = 1e-4, max_steps: int = 100000,
             disc_start: int = 20000, disc_type: str = "patchgan", disc_loss: str = "hinge",
             disc_adaptive_weight: bool = False, lpips_vgg: Optional[str] = None,
             lpips_lin: Optional[str] = None, ema: bool = False, log_every: int = 100,
             ckpt_every: int = 5000, eval_after: int = 64, results_dir: str = "results",
             seed: int = 0, device="cuda",
             log: Callable[[str], None] = print) -> Dict[str, object]:
    """Train the tokenizer `vq_config(vq_model_name)` from seed weights
    against a discriminator, as `train-vq` does. Returns {state, vq, disc,
    history (the logged metrics), eval (the reconstruction metrics, or
    None)}."""
    dev = resolve_device(device)
    vcfg = vq_config(vq_model_name)
    vq = vq_model.init_vq(vcfg, seed=seed, device=dev)
    if disc_type == "stylegan":
        disc = init_stylegan_disc(seed + 1, image_size=image_size, device=dev)
    else:
        disc = init_patchgan(seed + 1, device=dev)
    if lpips_vgg and lpips_lin:
        lp = convert_ref.lpips_from_state_dicts(ckpt_lib.load_torch_file(lpips_vgg),
                                                ckpt_lib.load_torch_file(lpips_lin), device=dev)
    else:
        log("[warn] random LPIPS weights (pass --lpips-vgg/--lpips-lin)")
        lp = init_lpips(seed, device=dev)
    tx_g = make_optimizer(lr=lr, beta1=0.9, beta2=0.95)
    tx_d = make_optimizer(lr=lr, beta1=0.9, beta2=0.95)
    state = init_vq_train_state(vq, disc, tx_g, tx_d, use_ema=ema)
    step = make_vq_train_step(vcfg, tx_g, tx_d, lp, disc_start=disc_start,
                              ema_decay=0.9999 if ema else None, disc_type=disc_type,
                              disc_adaptive_weight=disc_adaptive_weight,
                              disc_loss_type=disc_loss)

    files = image_files(images)
    rng = np.random.default_rng(seed)
    history = []
    for it in range(max_steps):
        idx = rng.integers(0, len(files), batch_size)
        batch = np.stack([load_crop(images, files[i], image_size) for i in idx])
        x = torch.from_numpy(batch).to(dev).float() / 127.5 - 1.0
        state, m = step(vq, disc, state, x)
        if it % log_every == 0:
            vals = {k: float(v) for k, v in m.items()}
            history.append({"step": it, **vals})
            log(f"step={it} " + " ".join(f"{k}={v:.4f}" for k, v in vals.items()))
        if (it + 1) % ckpt_every == 0:
            path = ckpt_lib.save_vq_train_state(os.path.join(results_dir, "vq_checkpoints"),
                                                state, step=it + 1)
            log(f"saved {path}")

    out = None
    if eval_after > 0:
        out = reconstruction_eval(
            vq, vcfg, uint8_batches(images, files[:eval_after], image_size, batch_size),
            out_dir=os.path.join(results_dir, "recon_eval"), device=dev)
        log("reconstruction gate: " + json.dumps(out))
    return {"state": state, "vq": vq, "disc": disc, "history": history, "eval": out}


def eval_vq(images: str, vq_ckpt: Optional[str] = None, image_size: int = 256,
            batch_size: int = 8, output_dir: Optional[str] = None,
            device="cuda") -> Dict[str, float]:
    """`eval-vq`: reconstruction metrics of VQ-16 (a checkpoint through
    `load_vq_checkpoint`, else seed 0's weights) over a folder."""
    dev = resolve_device(device)
    vcfg = vq_config("VQ-16")
    if vq_ckpt:
        vq = ckpt_lib.load_vq_checkpoint(vq_ckpt, vcfg, device=dev)
    else:
        vq = vq_model.init_vq(vcfg, seed=0, device=dev)
    return reconstruction_eval(
        vq, vcfg, uint8_batches(images, image_files(images), image_size, batch_size),
        out_dir=output_dir, device=dev)


def _train_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vq_train", description=__doc__.split("\n\n")[0])
    p.add_argument("--vq-model", default="VQ-16")
    p.add_argument("--images", required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--max-steps", type=int, default=100000)
    p.add_argument("--disc-start", type=int, default=20000)
    p.add_argument("--disc-type", default="patchgan", choices=["patchgan", "stylegan"])
    p.add_argument("--disc-loss", default="hinge",
                   choices=["hinge", "vanilla", "non-saturating"])
    p.add_argument("--disc-adaptive-weight", action="store_true",
                   help="grad-norm-ratio adaptive disc weight")
    p.add_argument("--lpips-vgg", default=None)
    p.add_argument("--lpips-lin", default=None)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--log-every", type=int, default=100)
    p.add_argument("--ckpt-every", type=int, default=5000)
    p.add_argument("--eval-after", type=int, default=64,
                   help="run the reconstruction gate on this many images after training "
                        "(0 disables)")
    p.add_argument("--results-dir", default="results")
    p.add_argument("--seed", type=int, default=0)
    return p


def _eval_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vq_train eval-vq")
    p.add_argument("--vq-ckpt", default=None)
    p.add_argument("--images", required=True)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--output-dir", default=None)
    return p


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["eval-vq"]:
        a = _eval_parser().parse_args(argv[1:])
        print(json.dumps(eval_vq(a.images, a.vq_ckpt, a.image_size, a.batch_size,
                                 a.output_dir)))
        return 0
    a = _train_parser().parse_args(argv)
    train_vq(a.images, a.vq_model, a.image_size, a.batch_size, a.lr, a.max_steps,
             a.disc_start, a.disc_type, a.disc_loss, a.disc_adaptive_weight, a.lpips_vgg,
             a.lpips_lin, a.ema, a.log_every, a.ckpt_every, a.eval_after, a.results_dir,
             a.seed, log=lambda m: print(m, file=sys.stderr if m.startswith("[warn]")
                                         else sys.stdout, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
