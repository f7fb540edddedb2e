"""Control fine-tuning: `Trainer.fit` steps on batches drawn from the seed.
The window counts the images of every step that ends in it; the check
follows the checked set-up steps with the reference."""
from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from portbench.harness import check as chk
from portbench.harness import program, traffic as tr
from portbench.harness.loops import Base, free_device, sync
from portbench.harness.trace import Slice, spanned
from portbench.reference import exact_fp32
from portbench.reference import gpt as ref_gpt

# Trainer.fit keys the randomness of its steps by its seed + 1234
# (controlar_tpu_torch/train/trainer.py); the reference replays the same keys
STEP_SEED_OFFSET = 1234


class Loop(Base):
    """`Trainer.fit` on batches of traffic["batch"] drawn from the seed, a
    pool of `pool` distinct batches in turn, at the configuration's
    dropout. Set-up takes the first `checked_steps` steps through `fit` and
    records what the check compares: each step's loss, each leaf's first
    gradient as AdamW got it (its first moment over 1 - beta1) and each
    leaf's change after those steps. The reference replays the steps'
    dropout from their keys (`reference/train.py`)."""

    def setup(self, seconds: float) -> None:
        from controlar_tpu_torch import convert_ref
        from controlar_tpu_torch.train.control_step import ControlModel
        from controlar_tpu_torch.train.optimizer import frozen_mask
        from controlar_tpu_torch.train.step import init_train_state
        from controlar_tpu_torch.train.trainer import Trainer, TrainerConfig

        t, g, dev, cfg = self.traffic, self.g, self.device, self.cfg
        o = cfg["train"]
        self.tmp = tempfile.TemporaryDirectory(prefix="portbench-train-")
        tcfg = TrainerConfig(
            gpt_model=g["size"], model_type=g["model_type"], image_size=cfg["image_px"],
            cls_token_num=g["cls_token_num"], vocab_size=g["vocab_size"],
            adapter_size={384: "small", 768: "base"}[g["adapter_dim"]],
            dropout_p=o["dropout"], class_dropout_prob=o["class_dropout"], lr=o["lr"],
            weight_decay=o["weight_decay"], beta1=o["beta1"], beta2=o["beta2"],
            max_grad_norm=o["max_grad_norm"], global_batch_size=t["batch"],
            remat_policy=o["remat"], opt_state_dtype=o["moments"], log_every=10 ** 9,
            ckpt_every=10 ** 9, results_dir=self.tmp.name, seed=self.seed,
            # the widths as the file states them (the registry's own at full size)
            model_overrides={k: g[k] for k in ("dim", "n_layer", "n_head", "caption_dim",
                                                "num_classes")},
            adapter_override=program.adapter_config(cfg))
        self.trainer = Trainer(tcfg, device=dev)
        self.drop_seed = drop_seed(cfg, self.seed)
        program.check_gpt_config(self.trainer.gpt_cfg, cfg)
        w = program.make_weights(cfg, self.seed, dev, parts=("gpt", "adapter"))
        gpt = convert_ref.gpt_from_state_dict(w.pop("gpt"), self.trainer.gpt_cfg, torch.float32, dev)
        adapter = convert_ref.vit_from_hf_state_dict(w.pop("adapter"), self.trainer.adapter_cfg,
                                                     device=dev)
        model = ControlModel(gpt, adapter)
        frozen = frozen_mask(dict(model.named_parameters()))
        for name, p in model.named_parameters():
            p.requires_grad_(not frozen[name])
        self.trainer.model = model
        self.keys = released_keys(model, self.trainer.adapter_cfg)
        self.batches = [tr.train_batch(g, t["batch"], cfg["image_px"], t["caption_min"],
                                       t["caption_max"], self.seed, i) for i in range(t["pool"])]
        self.fit = spanned("train_fit", self.trainer.fit)
        state = init_train_state(model, self.trainer.tx)
        # the checked steps, through the window's own call and feed
        n = t["checked_steps"]
        for k in range(n):
            state = self.fit(Loader(self.batches[k: k + 1]), state, max_steps=k + 1)
            if k == 0:
                b1 = self.trainer.tx.beta1
                self.grad_norms = {self.keys[nm]: float(m.float().norm()) / (1 - b1)
                                   for nm, m in state.opt_state.mu.items()}
        self.losses = [r["loss"] for r in self.trainer.history if r.get("first_step")][:n]
        ref0 = program.make_weights(cfg, self.seed, dev, parts=("gpt", "adapter"))
        ref0 = {**{"gpt." + k: v for k, v in ref0["gpt"].items()},
                **{"adapter." + k: v for k, v in ref0["adapter"].items()}}
        params = dict(model.named_parameters())
        self.update_norms = {}
        for nm, p in params.items():
            key = self.keys[nm]
            self.update_norms[key] = float((p.detach() - ref0.pop(key).reshape(p.shape)).norm())
        del ref0
        self.state = state
        sync(dev)

    def window(self, seconds: float) -> dict:
        dev = self.device
        sync(dev)
        t0 = time.perf_counter()
        step0 = self.state.step
        loader = Loader(self.batches, deadline=t0 + seconds)
        self.state = self.fit(loader, self.state)
        sync(dev)
        return {"kind": "train", "seconds": time.perf_counter() - t0,
                "steps": self.state.step - step0, "batch": self.traffic["batch"]}

    def trace_slice(self, steps: int, save=None) -> dict:
        with Slice(self.device, save) as s:
            self.state = self.fit(Loader(self.batches[:steps]), self.state,
                                  max_steps=self.state.step + steps)
        g = self.g
        return {**s.summary, "kind": "train", "steps": steps, "batch": self.traffic["batch"],
                "t": g["cls_token_num"] + g["block_size"] - 1, "bias": g["model_type"] == "t2i"}

    def free(self) -> None:
        self.trainer = self.state = self.fit = None
        self.tmp.cleanup()
        free_device(self.device)

    def check(self, limits: dict) -> Tuple[List[chk.Number], int, int]:
        exact_fp32()
        numbers = reference_train_numbers(self, program.reference_weights(
            self.cfg, self.seed, self.device, parts=("gpt", "adapter")))
        return chk.compared(numbers, limits), self.traffic["checked_steps"], 0


def drop_seed(cfg: dict, seed: int) -> Optional[int]:
    """The step seed the reference replays dropout from; None without dropout."""
    o = cfg["train"]
    return seed + STEP_SEED_OFFSET if o["dropout"] > 0 or o["class_dropout"] > 0 else None


def reference_train_numbers(loop, w, mm=ref_gpt.plain_matmul):
    """Follow the checked steps with the reference; -> [(name, value)].
    `loop` holds the program's readings (losses, grad_norms, update_norms)
    and the steps' `drop_seed`."""
    from portbench.reference.train import Step

    t, dev = loop.traffic, loop.device
    step = Step(w["gpt"], w["adapter"], loop.cfg, mm=mm, rows_per_block=t["reference_rows"],
                drop_seed=loop.drop_seed)
    p0 = {k: v.detach().clone() for k, v in step.params.items()}
    losses, grad_norms = [], None
    for k in range(t["checked_steps"]):
        batch = {name: torch.as_tensor(v, device=dev) for name, v in loop.batches[k].items()}
        loss, grads = step.loss_and_grads(batch)
        clipped = step.apply(grads)
        losses.append(loss)
        if k == 0:
            grad_norms = {n: float(gr.norm()) for n, gr in clipped.items()}
        del grads, clipped
    update = {n: float((step.params[n].detach() - p0[n]).norm()) for n in p0}
    keep = chk.moved_leaves(grad_norms)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(loop.losses, losses))
    return [("loss_gap", loss_gap),
            ("grad_gap", chk.leaf_gap(loop.grad_norms, grad_norms, keep)[0]),
            ("update_gap", chk.leaf_gap(loop.update_norms, update, keep)[0])]


class Loader:
    """The trainer's loader protocol over host batches: each epoch yields
    them in turn, forever while the host clock is before `deadline`, else
    once each."""

    def __init__(self, batches, deadline: Optional[float] = None):
        self.batches, self.deadline = batches, deadline

    def set_epoch(self, epoch: int) -> None:
        pass

    def __iter__(self):
        if self.deadline is None:
            yield from self.batches
            return
        i = 0
        while time.perf_counter() < self.deadline:
            yield self.batches[i % len(self.batches)]
            i += 1


def released_keys(model, adapter_cfg) -> Dict[str, str]:
    """The program's parameter names -> the released checkpoints' keys
    ("gpt." / "adapter." in front), matched by storage through the program's
    own exporters."""
    from controlar_tpu_torch import convert_ref

    out = {}
    for part, sd in (("gpt", convert_ref.gpt_reference_state_dict(model.gpt)),
                     ("adapter", convert_ref.vit_hf_state_dict(model.adapter, adapter_cfg))):
        by_ptr = {v.data_ptr(): k for k, v in sd.items()}
        for name, p in getattr(model, part).named_parameters():
            out[f"{part}.{name}"] = f"{part}.{by_ptr[p.data_ptr()]}"
    return out
