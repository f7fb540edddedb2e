"""Worker processes for the port's multi-process CPU tests.

`run(fn, world, *args)` starts `world` processes on the spawn context, joins
them into a gloo process group on a free port of a bound socket (so
parallel test workers never collide), calls `fn(*args)` in each, and
returns the ranks' results in rank order. The processes are joined under
one timeout (`TIMEOUT_S`) and killed when it runs out. This module imports
torch and the port only, never JAX: each worker stays a plain torch
process.
"""
from __future__ import annotations

import contextlib
import os
import socket
import tempfile
import traceback

import numpy as np
import torch

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, fn, args, out_dir: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    path = os.path.join(out_dir, f"rank{rank}.pt")
    try:
        dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        out = fn(*args)
        dist.destroy_process_group()
        torch.save({"ok": out}, path)
    except BaseException:  # the parent raises with the worker's traceback
        torch.save({"error": traceback.format_exc()}, path)
        raise


def run(fn, world: int, *args, timeout: float = TIMEOUT_S):
    """fn(*args) in `world` gloo ranks -> their results in rank order."""
    ctx = torch.multiprocessing.get_context("spawn")
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="torch_par_") as out_dir:
        procs = [ctx.Process(target=_entry, args=(r, world, port, fn, args, out_dir))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = timeout
        import time

        t0 = time.monotonic()
        for p in procs:
            p.join(max(0.0, deadline - (time.monotonic() - t0)))
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
        results = []
        for r in range(world):
            path = os.path.join(out_dir, f"rank{r}.pt")
            got = torch.load(path, weights_only=False) if os.path.exists(path) else None
            if got is not None and "error" in got:
                raise RuntimeError(f"rank {r} failed:\n{got['error']}")
            if got is None:
                raise RuntimeError(f"rank {r} gave no result (timed out after {timeout} s: "
                                   f"{bool(alive)}; exit code {procs[r].exitcode})")
            results.append(got["ok"])
        return results


# ---------------------------------------------------------------------------
# Workers (module-level, so the spawned processes can import them)
# ---------------------------------------------------------------------------

def mesh_groups(mesh_shape):
    """-> (this rank's coordinates, {axis: the ranks of its group, or None})."""
    import torch.distributed as dist

    from controlar_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(*mesh_shape)
    return mesh.coords, {a: None if g is None else dist.get_process_group_ranks(g)
                         for a, g in mesh.groups.items()}


def tp_generate(mesh_shape, cfg_kw, state_dict, quant, gen_kw):
    """Greedy `generate` of a GPT (state_dict's weights) split over the
    mesh's tp axis; quant "int8" quantizes it first (with the int8 cache).
    -> tokens (numpy)."""
    from controlar_tpu_torch import generate as tgen
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.parallel.mesh import make_mesh
    from controlar_tpu_torch.parallel.sharding import shard_gpt_tp
    from controlar_tpu_torch.quant import quantize_gpt

    cfg = GPTConfig(**cfg_kw)
    model = tgpt.init_gpt(cfg, seed=0)
    model.load_state_dict(state_dict)
    kw = dict(gen_kw)
    if quant:
        quantize_gpt(model, cfg, "int8")
        kw["cache_dtype"] = torch.int8
    rank_cfg = shard_gpt_tp(model, cfg, make_mesh(*mesh_shape))
    return tgen.generate(model, rank_cfg, device="cpu", **kw).numpy()


def record_first_grads(tx) -> dict:
    """Wrap tx.step so that the gradients of its first call (before the
    clip, which works on them in place) are kept: -> the dict they go to."""
    real, seen = tx.step, {}

    def step(params, grads, state, norm=None):
        if not seen:
            seen.update({n: g.detach().float().clone() for n, g in grads.items()})
        return real(params, grads, state, norm=norm)

    tx.step = step
    return seen


@contextlib.contextmanager
def exact_attention():
    """The training attention's plain version without its bf16 rounding of
    q, k, v, p and ds (the kernels' operand type): with it, two fp32 sums
    of one value in another order, one ulp apart, stay one ulp apart
    instead of landing on two bf16 values 2**-8 apart."""
    from controlar_tpu_torch.ops import flash_train

    real = flash_train._bf
    flash_train._bf = lambda x: x
    try:
        yield
    finally:
        flash_train._bf = real


def control_step(mesh_shape, kind, cfg_kw, adapter_kw, state_dict, runs, lr, steps):
    """For each named run (batch, exact), `steps` control train steps (fp32
    compute, EMA 0.9) of a ControlModel from state_dict's weights over the
    mesh, each rank on its rows of the batch, the attention exact
    (`exact_attention`) or not. -> {run name: {loss, grad_norm (per step),
    grads (the whole gradients the first step reduced, before its clip),
    params (the whole parameters after the steps), moment_bytes (this
    rank's Adam moments)}}; grads and params on rank 0 only."""
    from controlar_tpu_torch.config import GPTConfig
    from controlar_tpu_torch.models import gpt as tgpt
    from controlar_tpu_torch.models import vit as tvit
    from controlar_tpu_torch.parallel.mesh import make_mesh
    from controlar_tpu_torch.parallel.sharding import (
        batch_split,
        model_layout,
        rank_config,
        shard_training,
    )
    from controlar_tpu_torch.train import control_step as tcs
    from controlar_tpu_torch.train import optimizer as topt
    from controlar_tpu_torch.train import step as tstep

    cfg, acfg = GPTConfig(**cfg_kw), tvit.ViTConfig(**adapter_kw)
    mesh = make_mesh(*mesh_shape)
    out = {}
    for name, (batch, exact) in runs.items():
        model = tcs.ControlModel(tgpt.init_gpt(cfg, seed=0), tvit.init_vit(acfg, seed=1))
        model.load_state_dict(state_dict)
        frozen = topt.frozen_mask(dict(model.named_parameters()))
        for n, p in model.named_parameters():
            p.requires_grad_(not frozen[n])
        tx = topt.make_optimizer(lr=lr)
        first_grads = record_first_grads(tx)
        layout = model_layout(mesh, model, cfg)
        state = tstep.init_train_state(model, tx, use_ema=True)
        state = shard_training(layout, model, model.gpt, cfg, state)
        fn = tcs.make_control_train_step(rank_config(cfg, mesh.size("tp")), acfg, tx, "canny",
                                         ema_decay=0.9, compute_dtype=torch.float32,
                                         layout=layout)
        i, n = batch_split(mesh)
        rows = len(batch["tokens"]) // n
        local = {k: torch.from_numpy(np.asarray(v)[i * rows:(i + 1) * rows])
                 for k, v in batch.items()}
        losses, norms = [], []
        with exact_attention() if exact else contextlib.nullcontext():
            for _ in range(steps):
                state, metrics = fn(model, state, local, 0)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
        full = layout.full_state(state)
        grads = layout.unshard(first_grads)
        main = torch.distributed.get_rank() == 0
        out[name] = {
            "loss": losses, "grad_norm": norms, "grads": grads if main else None,
            "params": {k: v.clone() for k, v in full.params.items()} if main else None,
            "moment_bytes": sum(t.numel() * t.element_size()
                                for d in (state.opt_state.mu, state.opt_state.nu)
                                for t in d.values())}
    return out


def trainer_checkpoint(trainer_kw, results_dir, dataset_kw, steps):
    """`Trainer.fit` for `steps` steps over the mesh of trainer_kw (its
    data / fsdp / tp axes) on the tiny dataset, then `save_checkpoint`.
    -> {path (rank 0), moment_bytes, history}."""
    from controlar_tpu_torch.data.loader import ShardedLoader
    from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

    tr = Trainer(TrainerConfig(results_dir=results_dir, **trainer_kw), device="cpu")
    index, count = tr.batch_split()
    ds = TinyControlDataset(**dataset_kw)
    loader = ShardedLoader(ds, tr.cfg.global_batch_size // count, shuffle=False,
                           process_index=index, process_count=count, num_workers=1)
    state = tr.fit(loader, max_steps=steps)
    path = tr.save_checkpoint(state)
    moments = sum(t.numel() * t.element_size() for d in (state.opt_state.mu, state.opt_state.nu)
                  for t in d.values())
    return {"path": path, "moment_bytes": moments, "history": tr.history}


class TinyControlDataset:
    """n seed-made c2i control samples: tokens, a label, a uint8 image."""

    def __init__(self, n: int, tokens: int, image_px: int, vocab: int, classes: int,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.tokens = rng.integers(0, vocab, (n, tokens)).astype(np.int32)
        self.labels = rng.integers(0, classes, (n,)).astype(np.int32)
        self.images = rng.integers(0, 255, (n, image_px, image_px, 3)).astype(np.uint8)

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        return {"tokens": self.tokens[i], "labels": self.labels[i],
                "control_image": self.images[i], "valid": np.float32(1.0)}

    @staticmethod
    def make_batch(items):
        return {k: np.stack([it[k] for it in items]) for k in items[0]}
