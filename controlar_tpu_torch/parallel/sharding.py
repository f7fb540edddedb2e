"""Data, fully sharded (fsdp) and tensor (tp) parallelism over a `mesh.Mesh`
of process groups, in eager torch (the JAX package's `parallel/sharding.py`,
whose partition specs GSPMD turns into collectives).

Tensor parallelism, the Megatron way:
- column-parallel over tp: wqkv, w1, w3 and the control MLPs' fc1 (the
  adapter, condition, fusion and caption MLPs); a rank keeps its slice of
  the output features. wqkv is [q heads | k heads | v heads], so a rank
  takes its heads from each of the three sections (`TPSpec.sections`);
- row-parallel over tp: wo, w2 and those MLPs' fc2; a rank keeps the matching
  input features and its partial products are summed by an all-reduce;
- the embeddings, norms, output head and the ViT adapter stay whole on
  every rank.
The module's forward input goes through `copy_to_tp` (identity forward,
all-reduce of the gradient backward) before a column-parallel product, and
the row-parallel product through `reduce_from_tp` (all-reduce forward,
identity backward), as forward hooks, so the layer code and the parameter
names stay as they are and the same modules train and decode. Every rank
then holds the same activations between layers, so every rank computes the
same logits and draws the same token from the same seeded generator. A
rank's model runs under its `TPConfig`: its n_head and n_kv_head are its
own heads, head_dim and dim stay the model's.

Fully sharded data parallelism (`ShardLayout`): each rank keeps its piece
of every (tp-local) fp32 master along dim 0 (padded to a multiple of the
fsdp size) and the optimizer moments of that piece; a step all-gathers the
compute-dtype copies whole, and reduce-scatters the gradients. Gradients
are summed over the data axis, each rank's weighted by its share of the
batch's loss weight, so the step computes the one-card step's mean over the
whole batch. The batch is split over (data, fsdp) (the JAX package's
`batch_spec`).

The JAX package's `constrain_batch` and `mesh_active` are sharding hints to
XLA's partitioner; eager torch has no partitioner, so they have no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch import nn

from controlar_tpu_torch.config import GPTConfig
from controlar_tpu_torch.parallel.mesh import Mesh
from controlar_tpu_torch.quant import W4Linear, W8Linear

Tensors = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# The rank's configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPConfig(GPTConfig):
    """A tensor-parallel rank's view of a GPTConfig: n_head and n_kv_head
    count the rank's heads, tp the ranks; head_dim is the model's
    (dim // (n_head * tp)) and ffn_hidden_dim the rank's share."""
    tp: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // (self.n_head * self.tp)

    @property
    def ffn_hidden_dim(self) -> int:
        return GPTConfig.ffn_hidden_dim.fget(self) // self.tp


def rank_config(cfg: GPTConfig, tp: int) -> GPTConfig:
    """The configuration a tp rank runs under (cfg itself at tp 1)."""
    if tp == 1:
        return cfg
    kv = cfg.n_kv_head
    if cfg.n_head % tp or (kv is not None and kv % tp) or GPTConfig.ffn_hidden_dim.fget(cfg) % tp \
            or cfg.dim % tp:
        raise ValueError(f"tp {tp} does not divide the heads ({cfg.n_head}, kv {cfg.kv_heads}), "
                         f"the FFN width or dim of this model")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(GPTConfig)}
    fields.update(n_head=cfg.n_head // tp, n_kv_head=None if kv is None else kv // tp)
    return TPConfig(**fields, tp=tp)


# ---------------------------------------------------------------------------
# Collectives as autograd functions
# ---------------------------------------------------------------------------

def all_reduce(x: torch.Tensor, group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """Sum over the group, in place; x itself when there is no group."""
    if group is not None:
        dist.all_reduce(x, group=group)
    return x


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward; the gradient summed over the tp group backward."""
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the tp group forward; identity backward."""
    return _ReduceFromTP.apply(x, group)


# ---------------------------------------------------------------------------
# Tensor-parallel plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPSpec:
    """A weight split over tp along `dim` of its torch (out, in) layout:
    each of `sections` (lengths along dim, in order) is cut into tp equal
    parts, and rank r keeps part r of every section. kind "column" or
    "row" names the product (the hook its module gets)."""
    dim: int
    sections: Tuple[int, ...]
    kind: str


_CONTROL_MLPS = r"(adapter_mlp|condition_mlp|condition_layers\.\d+|cls_embedding)"


def gpt_tp_specs(cfg: GPTConfig, names) -> Dict[str, TPSpec]:
    """The TPSpec of each split GPT weight among `names` (a GPT's parameter
    names, with any prefix); the others stay whole."""
    d, hd, f = cfg.dim, cfg.head_dim, cfg.ffn_hidden_dim
    rules = (
        (r"layers\.\d+\.wqkv\.weight", TPSpec(0, (cfg.n_head * hd, cfg.kv_heads * hd,
                                                   cfg.kv_heads * hd), "column")),
        (r"layers\.\d+\.wo\.weight", TPSpec(1, (cfg.n_head * hd,), "row")),
        (r"layers\.\d+\.w[13]\.weight", TPSpec(0, (f,), "column")),
        (r"layers\.\d+\.w2\.weight", TPSpec(1, (f,), "row")),
        (_CONTROL_MLPS + r"\.fc1\.weight", TPSpec(0, (d,), "column")),
        (_CONTROL_MLPS + r"\.fc2\.weight", TPSpec(1, (d,), "row")),
    )
    specs = {}
    for n in names:
        for pattern, spec in rules:
            if re.search(r"(^|\.)" + pattern + "$", n):
                specs[n] = spec
    return specs


def tp_slice(full: torch.Tensor, spec: TPSpec, rank: int, tp: int, dim: Optional[int] = None
             ) -> torch.Tensor:
    """Rank `rank`'s part of a whole tensor (contiguous). dim overrides
    spec.dim (a W8 weight is stored (in, out))."""
    dim = spec.dim if dim is None else dim
    parts, off = [], 0
    for length in spec.sections:
        part = length // tp
        parts.append(full.narrow(dim, off + rank * part, part))
        off += length
    return torch.cat(parts, dim=dim).contiguous()


def tp_unslice(pieces, spec: TPSpec) -> torch.Tensor:
    """The whole tensor from every rank's part (`tp_slice`'s inverse)."""
    tp = len(pieces)
    out = []
    for s, length in enumerate(spec.sections):
        part = length // tp
        off = sum(ln // tp for ln in spec.sections[:s])
        out.extend(p.narrow(spec.dim, off, part) for p in pieces)
    return torch.cat(out, dim=spec.dim)


def _shard_module(m: nn.Module, spec: TPSpec, rank: int, tp: int, group) -> None:
    """Keep rank's part of a linear's weight (nn.Linear (out, in), or
    W8Linear q (in, out) and s (1, out)) and hook the module's collective."""
    with torch.no_grad():
        if isinstance(m, W4Linear):
            raise NotImplementedError(
                "W4 weights under tensor parallelism: the fused W4 FFN's output would need "
                "its all-reduce; quantize with mode='int8' or run tp 1")
        if isinstance(m, W8Linear):
            m.q = tp_slice(m.q, spec, rank, tp, dim=1 - spec.dim)
            if spec.kind == "column":
                m.s = tp_slice(m.s, spec, rank, tp, dim=1)
        elif isinstance(m, nn.Linear):
            w = tp_slice(m.weight, spec, rank, tp)
            m.weight = nn.Parameter(w, requires_grad=m.weight.requires_grad)
            m.out_features, m.in_features = w.shape
        else:
            raise TypeError(f"cannot split {type(m).__name__} over tp")
    if spec.kind == "column":
        m.register_forward_pre_hook(lambda mod, args: (copy_to_tp(args[0], group), *args[1:]))
    else:
        m.register_forward_hook(lambda mod, args, out: reduce_from_tp(out, group))


def _weight_names(model: nn.Module):
    """The names of the split candidates' weights: parameters of nn.Linear
    and the `.weight` standing for a W8Linear's q."""
    for name, m in model.named_modules():
        if isinstance(m, (nn.Linear, W8Linear, W4Linear)):
            yield f"{name}.weight", m


def shard_gpt_tp(model: nn.Module, cfg: GPTConfig, mesh: Mesh) -> GPTConfig:
    """Split a whole GPT (float or W8) over the mesh's tp axis in place:
    keep this rank's heads and FFN / control-MLP features and hook the
    collectives. Returns the configuration the rank runs under: pass it to
    `generate`, or as gpt_cfg to a `ControlARPipeline` (its adapter, VQ
    decoder and condition networks stay whole on every rank). A model with
    W4 weights raises. At tp 1 nothing changes."""
    tp = mesh.size("tp")
    if tp == 1:
        return cfg
    modules = dict(_weight_names(model))
    specs = gpt_tp_specs(cfg, modules)
    for name, spec in specs.items():
        _shard_module(modules[name], spec, mesh.index("tp"), tp, mesh.group("tp"))
    return rank_config(cfg, tp)


# ---------------------------------------------------------------------------
# Training state over the mesh
# ---------------------------------------------------------------------------

def _gather(x: torch.Tensor, group, size: int):
    """All-gather x (this rank's piece) over group -> list of `size` pieces."""
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


class ShardLayout:
    """Where each parameter of a training state lives on the mesh: its tp
    split (`TPSpec`, or whole) and its fsdp piece along dim 0. Built on the
    whole (one-card) parameters; `shard_state` turns a one-card `TrainState`
    into this rank's, `full_state` back. Every method that communicates must
    be called by every rank in the same order."""

    def __init__(self, mesh: Mesh, shapes: Dict[str, torch.Size], tp_specs: Dict[str, TPSpec]):
        self.mesh = mesh
        self.tp_specs = tp_specs
        tp = mesh.size("tp")
        self.local_shapes = {}
        for n, shape in shapes.items():
            shape = list(shape)
            if n in tp_specs:
                shape[tp_specs[n].dim] //= tp
            self.local_shapes[n] = torch.Size(shape)
        f = mesh.size("fsdp")
        self.rows = {n: math.ceil(s[0] / f) for n, s in self.local_shapes.items()}

    # -- fsdp pieces -------------------------------------------------------
    def _piece(self, n: str, local: torch.Tensor) -> torch.Tensor:
        f = self.mesh.size("fsdp")
        if f == 1:
            return local
        rows, i = self.rows[n], self.mesh.index("fsdp")
        pad = rows * f - local.shape[0]
        if pad:
            local = torch.cat([local, local.new_zeros((pad, *local.shape[1:]))])
        return local[i * rows:(i + 1) * rows].clone()

    def _unpiece(self, n: str, piece: torch.Tensor) -> torch.Tensor:
        f = self.mesh.size("fsdp")
        if f == 1:
            return piece
        full = torch.cat(_gather(piece, self.mesh.group("fsdp"), f))
        return full[: self.local_shapes[n][0]]

    def _tp_local(self, n: str, full: torch.Tensor) -> torch.Tensor:
        spec = self.tp_specs.get(n)
        if spec is None or self.mesh.size("tp") == 1:
            return full
        return tp_slice(full, spec, self.mesh.index("tp"), self.mesh.size("tp"))

    def _tp_full(self, n: str, local: torch.Tensor) -> torch.Tensor:
        spec = self.tp_specs.get(n)
        if spec is None or self.mesh.size("tp") == 1:
            return local
        pieces = _gather(local, self.mesh.group("tp"), self.mesh.size("tp"))
        return tp_unslice(pieces, spec)

    def shard(self, full: Tensors) -> Tensors:
        """Whole tensors (one-card layout) -> this rank's pieces."""
        return {n: self._piece(n, self._tp_local(n, t)) for n, t in full.items()}

    def unshard(self, pieces: Tensors) -> Tensors:
        """This rank's pieces -> whole tensors (every rank gets them)."""
        return {n: self._tp_full(n, self._unpiece(n, t)) for n, t in pieces.items()}

    # -- a step ------------------------------------------------------------
    def gather_params(self, params: Tensors, dtype: torch.dtype) -> Tensors:
        """The tp-local tensors in the compute dtype, gathered over fsdp,
        as leaves (gradients on for the trainable masters)."""
        out = {}
        for n, p in params.items():
            t = self._unpiece(n, p.detach().to(dtype)).detach()
            out[n] = t.requires_grad_(p.requires_grad)
        return out

    def reduce_grads(self, grads: Tensors, share: torch.Tensor) -> Tensors:
        """Gradients of the tp-local tensors, scaled by this rank's share of
        the loss weight, summed over the data-parallel ranks -> fp32 pieces
        (reduce-scatter over fsdp, all-reduce over data)."""
        f, fg = self.mesh.size("fsdp"), self.mesh.group("fsdp")
        out = {}
        for n, g in grads.items():
            g = g.float() * share
            if f > 1:
                rows = self.rows[n]
                pad = rows * f - g.shape[0]
                if pad:
                    g = torch.cat([g, g.new_zeros((pad, *g.shape[1:]))])
                piece = g.new_empty((rows, *g.shape[1:]))
                dist.reduce_scatter_tensor(piece, g.contiguous(), group=fg)
                g = piece
            out[n] = all_reduce(g, self.mesh.group("data"))
        return out

    def loss_share(self, weight: torch.Tensor) -> torch.Tensor:
        """This rank's loss weight over the data-parallel ranks' total."""
        w = weight.detach().float().reshape(())
        total = all_reduce(w.clone(), self.mesh.group("dp"))
        return torch.where(total > 0, w / torch.clamp(total, min=1e-30), torch.zeros_like(w))

    def dp_sum(self, x: torch.Tensor) -> torch.Tensor:
        return all_reduce(x.detach().clone(), self.mesh.group("dp"))

    def global_norm(self, grads: Tensors) -> torch.Tensor:
        """The norm of the whole model's gradient: squares summed over the
        fsdp pieces and the tp-split tensors, each whole tensor once."""
        split, whole = [], []
        for n, g in grads.items():
            (split if n in self.tp_specs and self.mesh.size("tp") > 1 else whole).append(
                g.float().square().sum())
        zero = next(iter(grads.values())).new_zeros((), dtype=torch.float32)
        sq_split = torch.stack(split).sum() if split else zero
        sq = all_reduce(sq_split, self.mesh.group("tp")) + (torch.stack(whole).sum()
                                                            if whole else zero)
        return torch.sqrt(all_reduce(sq, self.mesh.group("fsdp")))

    # -- whole states ------------------------------------------------------
    def shard_state(self, state):
        """A one-card TrainState (whole tensors) -> this rank's."""
        from controlar_tpu_torch.train.optimizer import AdamState
        from controlar_tpu_torch.train.step import TrainState

        params = {n: self._piece(n, self._tp_local(n, p.detach())).clone()
                  .requires_grad_(p.requires_grad) for n, p in state.params.items()}
        opt = state.opt_state
        return TrainState(state.step, params,
                          AdamState(opt.count, self.shard(opt.mu), self.shard(opt.nu)),
                          None if state.ema_params is None else self.shard(state.ema_params))

    def full_state(self, state):
        """This rank's TrainState -> the whole one (every rank gets it): the
        layout of one card's, which loads onto any mesh."""
        from controlar_tpu_torch.train.optimizer import AdamState
        from controlar_tpu_torch.train.step import TrainState

        opt = state.opt_state
        return TrainState(state.step, self.unshard({n: p.detach() for n, p in
                                                    state.params.items()}),
                          AdamState(opt.count, self.unshard(opt.mu), self.unshard(opt.nu)),
                          None if state.ema_params is None else self.unshard(state.ema_params))


def model_layout(mesh: Mesh, model: nn.Module, gpt_cfg: GPTConfig) -> ShardLayout:
    """The layout of a whole model's parameters (a GPT, or a module holding
    one, e.g. the control step's `ControlModel`) over the mesh."""
    shapes = {n: p.shape for n, p in model.named_parameters()}
    return ShardLayout(mesh, shapes, gpt_tp_specs(gpt_cfg, shapes))


def shard_training(layout: ShardLayout, model: nn.Module, gpt: nn.Module, gpt_cfg: GPTConfig,
                   state):
    """A one-card TrainState over `model`'s parameters (whole on every rank)
    -> this rank's, with `gpt` (model's GPT) split over tp in place and the
    module's own tensors released: the step binds the gathered pieces
    (`train.step.apply_step`)."""
    state = layout.shard_state(state)
    shard_gpt_tp(gpt, gpt_cfg, layout.mesh)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.new_empty(0)
    return state


def batch_split(mesh: Mesh) -> Tuple[int, int]:
    """(index, count) of this rank's share of the batch: the batch is split
    over (data, fsdp), and the tp ranks of a replica read the same rows."""
    return mesh.index("dp"), mesh.size("dp")
