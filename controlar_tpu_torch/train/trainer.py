"""The training loop: data, the control train step, logging, checkpoints (the
JAX package's `train/trainer.py`).

`Trainer(cfg, device="cuda").fit(loader, max_steps=N)` takes N AdamW steps of
`train/control_step.make_control_train_step`. In one process it trains on
one card. In a process group (`parallel.distributed.init`, e.g. under
torchrun) it trains over the (data, fsdp, tp) mesh of cfg.data_axis,
fsdp_axis and tp_axis, whose product must be the world size
(`parallel.sharding`): each rank reads its share of the batch
(`batch_split`, the loader's process_index / process_count), keeps its
pieces of the masters and moments, and runs its tp heads; rank 0 alone logs
and writes checkpoints, which always hold the whole state in one card's
layout, so a checkpoint loads onto any mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from controlar_tpu_torch import checkpoint as ckpt_lib
from controlar_tpu_torch import resolve_device
from controlar_tpu_torch.config import GPTConfig, gpt_config
from controlar_tpu_torch.models import gpt as gpt_model
from controlar_tpu_torch.models import vit as vit_model
from controlar_tpu_torch.parallel import distributed
from controlar_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from controlar_tpu_torch.parallel.sharding import (
    batch_split,
    model_layout,
    rank_config,
    shard_training,
)
from controlar_tpu_torch.spans import span
from controlar_tpu_torch.train.control_step import ControlModel, make_control_train_step
from controlar_tpu_torch.train.optimizer import frozen_mask, make_optimizer, step_lr
from controlar_tpu_torch.train.step import TrainState, init_train_state


@dataclasses.dataclass
class TrainerConfig:
    # model
    gpt_model: str = "GPT-XL"
    model_type: str = "t2i"
    image_size: int = 512
    downsample_size: int = 16
    condition_type: str = "canny"
    adapter_size: str = "small"
    cls_token_num: int = 120
    vocab_size: int = 16384
    dropout_p: float = 0.1
    # optimization (the reference trainers' defaults)
    lr: float = 1e-4
    # StepLR: lr * lr_gamma every lr_decay_every steps (0 disables)
    lr_gamma: float = 1.0
    lr_decay_every: int = 0
    weight_decay: float = 5e-2
    beta1: float = 0.9
    beta2: float = 0.95
    max_grad_norm: float = 1.0
    global_batch_size: int = 32
    epochs: int = 10
    ema: bool = False
    # backward rematerialization: "full", "qkv", "attn", "qkv_attn", "dots",
    # "none" (models/gpt.py REMAT_POLICIES)
    remat_policy: str = "full"
    # Adam moment storage: "float32" or "bfloat16" (update in fp32 either way)
    opt_state_dtype: str = "float32"
    ema_decay: float = 0.9999
    class_dropout_prob: float = 0.1
    # mesh over the process group: data -1 takes what fsdp x tp leave
    data_axis: int = -1
    fsdp_axis: int = 1
    tp_axis: int = 1
    # io
    results_dir: str = "results"
    ckpt_every: int = 10000
    log_every: int = 100
    # a torch.profiler trace of steps [profile_start_step, + profile_num_steps)
    profile_dir: Optional[str] = None
    profile_start_step: int = 10
    profile_num_steps: int = 5
    # experiment tracking: wandb when installed, and always metrics.jsonl
    wandb_project: Optional[str] = None
    wandb_run_name: Optional[str] = None
    # numbered experiment directories, results/000-GPT-XL, ...
    auto_exp_dir: bool = False
    gpt_ckpt: Optional[str] = None       # initial GPT weights
    resume_dir: Optional[str] = None
    seed: int = 0
    # test / custom hooks: GPT config overrides, an adapter config
    model_overrides: Optional[Dict[str, Any]] = None
    adapter_override: Optional[Any] = None

    def build_gpt_config(self) -> GPTConfig:
        block = (self.image_size // self.downsample_size) ** 2
        kw = dict(
            model_type=self.model_type,
            block_size=block,
            cls_token_num=self.cls_token_num,
            vocab_size=self.vocab_size,
            condition_type=self.condition_type,
            adapter_size=self.adapter_size,
            class_dropout_prob=self.class_dropout_prob,
            token_dropout_p=self.dropout_p,
            resid_dropout_p=self.dropout_p,
            ffn_dropout_p=self.dropout_p,
        )
        kw.update(self.model_overrides or {})
        return gpt_config(self.gpt_model, **kw)

    def build_adapter_config(self) -> vit_model.ViTConfig:
        if self.adapter_override is not None:
            return self.adapter_override
        return vit_model.DINOV2_SMALL if self.adapter_size == "small" else vit_model.DINOV2_BASE


def next_experiment_dir(root: str, name: str) -> str:
    """results/000-GPT-XL, results/001-GPT-XL, ..."""
    os.makedirs(root, exist_ok=True)
    taken = [int(d.split("-")[0]) for d in os.listdir(root)
             if os.path.isdir(os.path.join(root, d)) and d.split("-")[0].isdigit()]
    return os.path.join(root, f"{max(taken, default=-1) + 1:03d}-{name}")


class Trainer:
    def __init__(self, cfg: TrainerConfig, frozen: Optional[Dict[str, Any]] = None,
                 device="cuda"):
        shape = mesh_shape(distributed.world_size(), cfg.data_axis, cfg.fsdp_axis, cfg.tp_axis)
        self.device = resolve_device(device)
        self.cfg = cfg
        self.gpt_cfg = cfg.build_gpt_config()
        self.adapter_cfg = cfg.build_adapter_config()
        self.main = distributed.is_main_process()
        # in a process group the step runs over the mesh, a (1, 1, 1) one too
        self.mesh = make_mesh(*shape) if dist.is_initialized() else None
        self.layout = None
        step_cfg = self.gpt_cfg
        if self.mesh is not None:
            with torch.device("meta"):
                whole = ControlModel(gpt_model.GPT(self.gpt_cfg), vit_model.ViT(self.adapter_cfg))
            self.layout = model_layout(self.mesh, whole, self.gpt_cfg)
            step_cfg = rank_config(self.gpt_cfg, shape[2])
        schedule = None
        if cfg.lr_decay_every > 0 and cfg.lr_gamma != 1.0:
            schedule = step_lr(cfg.lr, cfg.lr_decay_every, cfg.lr_gamma)
        self.tx = make_optimizer(lr=cfg.lr, weight_decay=cfg.weight_decay, beta1=cfg.beta1,
                                 beta2=cfg.beta2, max_grad_norm=cfg.max_grad_norm,
                                 lr_schedule=schedule, state_dtype=cfg.opt_state_dtype)
        self.step_fn = make_control_train_step(
            step_cfg, self.adapter_cfg, self.tx, cfg.condition_type, frozen=frozen,
            ema_decay=cfg.ema_decay if cfg.ema else None, remat_policy=cfg.remat_policy,
            layout=self.layout)
        self.model: Optional[ControlModel] = None
        if cfg.auto_exp_dir and self.main:
            cfg.results_dir = next_experiment_dir(cfg.results_dir,
                                                  cfg.gpt_model.replace("/", "-"))
        self._log_file = self._metrics_file = None
        if self.main:
            os.makedirs(cfg.results_dir, exist_ok=True)
            self._log_file = open(os.path.join(cfg.results_dir, "log.txt"), "a")
            self._metrics_file = open(os.path.join(cfg.results_dir, "metrics.jsonl"), "a")
        self.history = []  # the records of log_metrics
        self._wandb = None
        if cfg.wandb_project and self.main:
            try:
                import wandb
            except ImportError:
                self.log("[warn] wandb_project set but wandb is not installed")
            else:
                self._wandb = wandb.init(project=cfg.wandb_project, name=cfg.wandb_run_name,
                                         config=dataclasses.asdict(cfg), resume="allow")

    def batch_split(self) -> Tuple[int, int]:
        """(process_index, process_count) of this rank's share of the
        batch for `ShardedLoader`: (0, 1) in one process."""
        return (0, 1) if self.mesh is None else batch_split(self.mesh)

    def log(self, msg: str) -> None:
        if not self.main:
            return
        print(msg, flush=True)
        self._log_file.write(msg + "\n")
        self._log_file.flush()

    def log_metrics(self, step: int, record: Dict[str, Any]) -> None:
        """One JSON line per log window (and a wandb point when configured)."""
        self.history.append({"step": step, **record})
        if not self.main:
            return
        self._metrics_file.write(json.dumps({"step": step, **record}) + "\n")
        self._metrics_file.flush()
        if self._wandb is not None:
            self._wandb.log(record, step=step)

    def init_state(self) -> TrainState:
        """Fresh fp32 weights from cfg.seed (GPT) and cfg.seed + 1 (adapter),
        the GPT's replaced by those of cfg.gpt_ckpt when given
        (`checkpoint.load_gpt_checkpoint`, cast to each parameter's dtype; the
        control modules a base checkpoint lacks stay the fresh ones), gradients on
        for every parameter but the frozen ones; the latest checkpoint of
        cfg.resume_dir restored when there is one. Over a mesh every rank
        builds the whole state so, then keeps its pieces (`ShardLayout`),
        and the GPT is split over tp; the module's own tensors are released,
        the step binding the gathered pieces."""
        cfg = self.cfg
        gpt = gpt_model.init_gpt(self.gpt_cfg, seed=cfg.seed, device=self.device)
        if cfg.gpt_ckpt:
            loaded = ckpt_lib.load_gpt_checkpoint(cfg.gpt_ckpt, self.gpt_cfg, device="cpu",
                                                  fill_from=gpt).state_dict()
            with torch.no_grad():
                for name, p in gpt.state_dict().items():
                    p.copy_(loaded[name].to(p.dtype))
            del loaded
            self.log(f"loaded GPT weights from {cfg.gpt_ckpt}")
        adapter = vit_model.init_vit(self.adapter_cfg, seed=cfg.seed + 1, device=self.device)
        self.model = ControlModel(gpt, adapter)
        frozen = frozen_mask(dict(self.model.named_parameters()))
        for n, p in self.model.named_parameters():
            p.requires_grad_(not frozen[n])
        state = init_train_state(self.model, self.tx, use_ema=cfg.ema)
        if cfg.resume_dir:
            latest = ckpt_lib.latest_checkpoint(cfg.resume_dir)
            if latest:
                state = ckpt_lib.restore_train_state(latest, state)
                self.log(f"resumed from {latest} at step {state.step}")
        if self.layout is not None:
            state = shard_training(self.layout, self.model, gpt, self.gpt_cfg, state)
        return state

    def save_checkpoint(self, state: TrainState) -> Optional[str]:
        """Write the whole state under results_dir/checkpoints (rank 0; over
        a mesh every rank takes part in gathering it). -> the path on rank
        0, else None."""
        if self.layout is not None:
            state = self.layout.full_state(state)
        path = None
        if self.main:
            path = ckpt_lib.save_train_state(os.path.join(self.cfg.results_dir, "checkpoints"),
                                             state)
            self.log(f"saved {path}")
        if self.mesh is not None:
            dist.barrier()
        return path

    def put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        """Host batch -> device tensors; on the card through pinned memory
        with non_blocking copies, so the host does not wait for the device.
        The profiler span `train.data`."""
        cuda = self.device.type == "cuda"

        def put(v):
            t = torch.as_tensor(np.asarray(v))
            return t.pin_memory().to(self.device, non_blocking=True) if cuda else t

        with span("train.data"):
            return {k: put(v) for k, v in batch.items() if not isinstance(v, list)}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def fit(self, loader, state: Optional[TrainState] = None,
            max_steps: Optional[int] = None) -> TrainState:
        """Train over cfg.epochs epochs of the loader (or max_steps steps).
        The first step is kept out of the throughput window; every log_every
        steps the window's mean loss, steps/s and images/s are logged, the
        window timed on the host clock between two synchronisations of the
        device (taken only when a line is logged), so it counts finished
        steps."""
        cfg = self.cfg
        state = state if state is not None else self.init_state()
        seed = cfg.seed + 1234
        t0 = time.perf_counter()
        running = []
        first_step_done = False
        profiler = None
        for epoch in range(cfg.epochs):
            loader.set_epoch(epoch)
            for batch in loader:
                state, metrics = self.step_fn(self.model, state, self.put_batch(batch), seed)
                running.append(metrics)
                step = state.step
                if not first_step_done:
                    self._sync()
                    loss = metrics["loss"].item()
                    dt = time.perf_counter() - t0
                    self.log(f"first step took {dt:.1f}s, loss={loss:.4f}")
                    self.log_metrics(step, {"epoch": epoch, "loss": loss, "first_step": True,
                                            "seconds": dt})
                    first_step_done = True
                    running, t0 = [], time.perf_counter()
                if cfg.profile_dir and self.main:
                    if step == cfg.profile_start_step and profiler is None:
                        profiler = self._start_profile()
                    elif profiler is not None and step >= (cfg.profile_start_step
                                                           + cfg.profile_num_steps):
                        self._stop_profile(profiler)
                        profiler = None
                if step % cfg.log_every == 0 and running:
                    self._sync()
                    dt = time.perf_counter() - t0
                    loss = float(np.mean([float(m["loss"]) for m in running]))
                    sps = len(running) / dt
                    ips = sps * cfg.global_batch_size
                    self.log(f"step={step:07d} epoch={epoch} loss={loss:.4f} "
                             f"steps/sec={sps:.2f} imgs/sec/chip={ips:.2f}")
                    self.log_metrics(step, {"epoch": epoch, "loss": loss,
                                            "steps_per_sec": round(sps, 4),
                                            "imgs_per_sec_chip": round(ips, 4),
                                            "steps": len(running), "seconds": dt})
                    running, t0 = [], time.perf_counter()
                if step % cfg.ckpt_every == 0:
                    self.save_checkpoint(state)
                if max_steps is not None and step >= max_steps:
                    if profiler is not None:
                        self._stop_profile(profiler)
                    return state
        if profiler is not None:
            self._stop_profile(profiler)
        return state

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize(self.device)  # the window holds only its own steps
        prof = profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.__exit__(None, None, None)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir, f"trace_step{self.cfg.profile_start_step}.json")
        prof.export_chrome_trace(path)
        self.log(f"profile trace written to {path}")
