"""Train a c2i GPT to convergence on a synthetic task, then measure what
quantization costs in tokens on the trained weights (the JAX package's
`scripts/toy_train_quant.py`).

Random-weight logits are near-uniform, so token agreement under
quantization and speculative acceptance measured on them are worst cases. A
converged model has confident logits: its agreement is the number that
stands beside the quantized modes until released checkpoints are in the
repository.

Tasks (labels from 16 classes; `toy_tokens`, `toy_tokens_chain`):
  basic  a deterministic sequence per class with 10% uniform token noise;
         the optimal CE is about 0.1 ln(V) + H(0.1) ~ 1.3, and a converged
         model emits ~0.9-confident tokens;
  chain  a Markov chain over a 512-state sub-vocabulary with 25% noise over
         the whole vocabulary: ~0.75-confident chain steps and a flat 16k
         tail at every position, where small logit shifts flip samples.

Training is the port's `train.step.make_train_step` with AdamW
(`train.optimizer.make_optimizer`, the moments in `--opt-state-dtype`) or,
with `--optimizer adafactor`, `train.optimizer.Adafactor` (optax's
chain(clip_by_global_norm(1.0), adafactor(lr)), as the JAX script builds
it; its state fp32);
attention runs on the training kernels on the card. After training the
model is cast to bf16 and measured with `eval.quant_report` in every mode of
`--quant-modes`, and greedy speculative decode with an int8 copy of itself
as the draft reports its accepted tokens per cycle (k = SPEC_K).
`--mid-ckpt-frac` also keeps a bf16 copy at that fraction of the steps (a
less converged, higher-entropy model) and reports on it.

    python -m controlar_tpu_torch.toy_train [--size GPT-B] [--steps 800]
        [--batch 16] [--task basic|chain] [--block-size 256] [--optimizer adamw|adafactor]
        [--ckpt-out DIR] [--load-ckpt DIR] [--json-out FILE] [--device cuda]

--ckpt-out saves the trained bf16 model as a port step directory
(`checkpoint.save_train_state` layout, loadable with
`checkpoint.load_gpt_checkpoint`); --load-ckpt skips training and reports
on such a checkpoint (or a JAX `.npz` dump).
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from controlar_tpu_torch import checkpoint as ckpt_lib
from controlar_tpu_torch import resolve_device
from controlar_tpu_torch import spec_decode
from controlar_tpu_torch.config import GPTConfig, gpt_config
from controlar_tpu_torch.eval.quant_report import format_report, measure_quant_agreement
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.quant import quantize_gpt
from controlar_tpu_torch.train.optimizer import Adafactor, AdamState, make_optimizer
from controlar_tpu_torch.train.step import TrainState, init_train_state, make_train_step

CHAIN_STATES = 512  # the deterministic-transition sub-vocabulary of the chain task


def toy_tokens(rng: np.random.Generator, labels: np.ndarray, block_size: int,
               vocab_size: int, noise: float = 0.1) -> np.ndarray:
    """A deterministic sequence per class, each token replaced by a uniform
    one with probability `noise`. -> (B, block_size) int32."""
    t = np.arange(block_size)[None, :]
    base = (labels[:, None] * 7919 + t * 104729 + labels[:, None] * t * 31) % vocab_size
    noise_mask = rng.random(base.shape) < noise
    rand = rng.integers(0, vocab_size, base.shape)
    return np.where(noise_mask, rand, base).astype(np.int32)


def toy_tokens_chain(rng: np.random.Generator, labels: np.ndarray, block_size: int,
                     vocab_size: int, noise: float = 0.25) -> np.ndarray:
    """t_i = f(t_{i-1} % 512, label), except with probability `noise` a
    token uniform over the whole vocabulary (the chain reseeds from it).
    -> (B, block_size) int32."""
    b = len(labels)
    toks = np.zeros((b, block_size), np.int64)
    prev = (labels.astype(np.int64) * 131) % CHAIN_STATES
    for t in range(block_size):
        det = (prev * 31 + labels * 97 + 7) % CHAIN_STATES
        noisy = rng.random(b) < noise
        rand = rng.integers(0, vocab_size, b)
        tok = np.where(noisy, rand, det)
        toks[:, t] = tok
        prev = tok % CHAIN_STATES
    return toks.astype(np.int32)


TASKS = {"basic": toy_tokens, "chain": toy_tokens_chain}
# each task's noise: the generators' own defaults, the tasks docs/quant_stress.md
# describes (the JAX script passes its --noise, 0.1 by default, to either task)
TASK_NOISE = {"basic": 0.1, "chain": 0.25}
# the JAX script's: init and data from seed 0, every step keyed 1, a loss
# logged every 50 steps; the int8 self-draft's drafts a cycle
SEED, STEP_KEY, LOG_EVERY, SPEC_K = 0, 1, 50, 4


def toy_config(size: str = "GPT-B", block_size: int = 256, **overrides) -> GPTConfig:
    """The c2i configuration of the toy runs: vocabulary 16384, 1000 classes,
    class dropout 0.1, no token, residual or FFN dropout."""
    kw = dict(model_type="c2i", cls_token_num=1, block_size=block_size, vocab_size=16384,
              num_classes=1000, class_dropout_prob=0.1, token_dropout_p=0.0,
              resid_dropout_p=0.0, ffn_dropout_p=0.0)
    kw.update(overrides)
    return gpt_config(size, **kw)


def toy_batches(task: str, cfg: GPTConfig, batch: int, num_classes_used: int = 16,
                noise: float = 0.1):
    """The endless stream of the JAX script's batches: labels, then tokens,
    from one numpy generator seeded with SEED."""
    rng = np.random.default_rng(SEED)
    fn = TASKS[task]
    while True:
        labels = rng.integers(0, num_classes_used, batch)
        yield {"labels": labels.astype(np.int32),
               "tokens": fn(rng, labels, cfg.block_size, cfg.vocab_size, noise)}


def train(cfg: GPTConfig, *, steps: int, batch: int = 16, lr: float = 3e-4,
          task: str = "basic", noise: Optional[float] = None, num_classes_used: int = 16,
          param_dtype: torch.dtype = torch.float32, opt_state_dtype: str = "bfloat16",
          mid_step: int = -1, model: Optional[gpt_model.GPT] = None,
          compute_dtype: torch.dtype = torch.bfloat16, optimizer: str = "adamw",
          device="cuda", log: Callable[[str], None] = print) -> Dict[str, object]:
    """Train `model` (default: `init_gpt(cfg, SEED)` in param_dtype) for
    `steps` steps on the toy task (noise None: the task's TASK_NOISE), in
    place, with the JAX script's seeds; optimizer "adamw" (moments in
    opt_state_dtype) or "adafactor". Returns {model, losses (every
    LOG_EVERY steps and the last), step_losses (every step, read at the
    end), mid (a bf16 copy after step mid_step, or None), ms_per_step
    (median of the synchronised steps after the first two), state}."""
    dev = resolve_device(device)
    if model is None:
        model = gpt_model.init_gpt(cfg, seed=SEED, dtype=param_dtype, device=dev)
    for n, p in model.named_parameters():
        p.requires_grad_(not n.endswith("uncond_embedding"))
    if optimizer == "adafactor":
        tx = Adafactor(lr=lr)
    elif optimizer == "adamw":
        tx = make_optimizer(lr=lr, state_dtype=opt_state_dtype)
    else:
        raise ValueError(f"optimizer must be 'adamw' or 'adafactor', got {optimizer!r}")
    state = init_train_state(model, tx)
    step_fn = make_train_step(cfg, tx, compute_dtype=compute_dtype)
    noise = TASK_NOISE[task] if noise is None else noise
    data = toy_batches(task, cfg, batch, num_classes_used, noise)
    step_losses: List[torch.Tensor] = []
    losses, seconds, mid = [], [], None
    t0 = time.perf_counter()
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(dev) for k, v in next(data).items()}
        ts = time.perf_counter()
        state, m = step_fn(model, state, b, STEP_KEY)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - ts)
        step_losses.append(m["loss"])
        if i == mid_step:
            mid = copy.deepcopy(model).to(torch.bfloat16).requires_grad_(False)
            log(f"step {i}: mid-training snapshot taken")
        if i % LOG_EVERY == 0 or i == steps - 1:
            losses.append(m["loss"].item())
            log(f"step {i}: loss {losses[-1]:.4f} ({time.perf_counter() - t0:.0f}s)")
    model.requires_grad_(False)
    timed = seconds[2:] or seconds
    return {"model": model, "losses": losses, "mid": mid,
            "step_losses": [float(x) for x in torch.stack(step_losses).cpu()],
            "ms_per_step": float(np.median(timed)) * 1e3 if timed else None,
            "state": state}


def save_params(model: gpt_model.GPT, ckpt_dir: str, step: int) -> str:
    """The model's parameters as a port step directory, loadable with
    `checkpoint.load_gpt_checkpoint`."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    return ckpt_lib.save_train_state(ckpt_dir, TrainState(step, params, AdamState(0, {}, {})),
                                     step)


@torch.inference_mode()
def spec_acceptance(model: gpt_model.GPT, cfg: GPTConfig, k: int, max_new_tokens: int,
                    labels, device) -> Dict[str, float]:
    """Greedy speculative decode with an int8 copy of the model drafting k
    tokens a cycle: accepted tokens per cycle and cycles."""
    draft = quantize_gpt(copy.deepcopy(model), cfg, "int8")
    _, stats = spec_decode.generate_spec(model, cfg, draft, labels=labels,
                                         max_new_tokens=max_new_tokens, k_draft=k,
                                         return_stats=True, device=device)
    return stats


def report(model: gpt_model.GPT, cfg: GPTConfig, modes, max_new_tokens: int, device,
           log: Callable[[str], None] = print) -> Dict[str, object]:
    """The quant report and the int8 self-draft's acceptance (SPEC_K drafts
    a cycle) on the bf16 model."""
    t0 = time.perf_counter()
    rep = measure_quant_agreement(model, cfg, modes=modes, max_new_tokens=max_new_tokens,
                                  device=device)
    log(format_report(rep))
    labels = torch.arange(4, device=device) % cfg.num_classes
    spec = spec_acceptance(model, cfg, SPEC_K, max_new_tokens, labels, device)
    log(f"spec (int8 self-draft, k={SPEC_K}): {spec}")
    return {"quant_report": rep, "quant_report_s": time.perf_counter() - t0,
            "spec_int8_self_draft": spec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", default="GPT-B")
    ap.add_argument("--block-size", type=int, default=256,
                    help="576 = the c2i 384 px serving workload")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--num-classes-used", type=int, default=16)
    ap.add_argument("--noise", type=float, default=None,
                    help="token noise (default TASK_NOISE: 0.1 basic, 0.25 chain)")
    ap.add_argument("--task", default="basic", choices=sorted(TASKS))
    ap.add_argument("--mid-ckpt-frac", type=float, default=0.0,
                    help="also snapshot the model at this fraction of training and report "
                         "on it")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "adafactor"],
                    help="adafactor: fp32 factored second moments, no first moment")
    ap.add_argument("--param-dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--opt-state-dtype", default="bfloat16", choices=["float32", "bfloat16"])
    ap.add_argument("--ckpt-out", default=None, help="save the trained bf16 model here")
    ap.add_argument("--load-ckpt", default=None,
                    help="skip training; report on this checkpoint (a --ckpt-out "
                         "directory or a JAX .npz dump)")
    ap.add_argument("--quant-modes", default="int8,int8+kv8,w4,w4+kv8,w4+kv4")
    ap.add_argument("--max-new-tokens", type=int, default=256)
    ap.add_argument("--json-out", default=None)
    ap.add_argument("--skip-quant", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    noise = TASK_NOISE[args.task] if args.noise is None else args.noise
    cfg = toy_config(args.size, args.block_size)
    modes = tuple(args.quant_modes.split(","))
    smi = _card_name(dev)
    out: Dict[str, object] = {
        "size": args.size, "steps": args.steps, "block_size": args.block_size,
        "batch": args.batch, "optimizer": args.optimizer, "task": args.task, "noise": noise,
        "max_new_tokens": args.max_new_tokens, "device": smi}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mid = None
    if args.load_ckpt:
        model = ckpt_lib.load_gpt_checkpoint(args.load_ckpt, cfg, torch.bfloat16, dev)
        out.update(steps=None, final_loss=None, losses=[])
    else:
        mid_step = int(args.steps * args.mid_ckpt_frac) if args.mid_ckpt_frac > 0 else -1
        t0 = time.perf_counter()
        res = train(cfg, steps=args.steps, batch=args.batch, lr=args.lr, task=args.task,
                    noise=noise, num_classes_used=args.num_classes_used,
                    param_dtype=getattr(torch, args.param_dtype),
                    opt_state_dtype=args.opt_state_dtype, mid_step=mid_step,
                    optimizer=args.optimizer, device=dev)
        out.update(final_loss=res["losses"][-1], losses=res["losses"],
                   ms_per_step=res["ms_per_step"], train_s=time.perf_counter() - t0)
        if dev.type == "cuda":
            out["train_peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        model, mid = res["model"], res["mid"]
        if mid is not None:
            out["mid_step"] = mid_step
        del res
        model = model.to(torch.bfloat16)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if args.ckpt_out:
        path = save_params(model, args.ckpt_out, args.steps)
        print(f"saved the trained bf16 model to {path}", flush=True)
        if mid is not None:
            save_params(mid, args.ckpt_out + "_mid", out["mid_step"])
    if not args.skip_quant:
        out.update(report(model, cfg, modes, args.max_new_tokens, dev))
        if mid is not None:
            del model
            print(f"mid-training checkpoint (step {out['mid_step']}):", flush=True)
            mid_out = report(mid, cfg, modes, args.max_new_tokens, dev)
            out["quant_report_mid"] = mid_out["quant_report"]
            out["spec_int8_self_draft_mid"] = mid_out["spec_int8_self_draft"]
    if dev.type == "cuda":
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    if args.json_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.json_out)), exist_ok=True)
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items()
                      if k not in ("quant_report", "quant_report_mid")}), flush=True)
    return 0


def _card_name(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as nvidia-smi gives them (None on the
    CPU, or when nvidia-smi cannot be run)."""
    if dev.type != "cuda":
        return None
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


if __name__ == "__main__":
    sys.exit(main())
