"""The (data, fsdp, tp) mesh as process groups (the JAX package's
`parallel/mesh.py`, whose mesh is a jax.sharding.Mesh over devices).

Rank r sits at (d, f, t) with r = (d * fsdp + f) * tp + t: tp is the
innermost axis, so a tensor-parallel group holds neighbouring ranks (one
host's cards under torchrun). Each rank keeps the group of each axis it
belongs to, and the group of its data-parallel replicas over (data, fsdp),
over which the batch is split. Axes of size 1 have no group: the
collectives skip them, so a (1, 1, 1) mesh runs without communication.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional, Tuple

import torch.distributed as dist

AXES = ("data", "fsdp", "tp")


@dataclasses.dataclass(frozen=True)
class Mesh:
    shape: Tuple[int, int, int]     # (data, fsdp, tp)
    coords: Tuple[int, int, int]    # this rank's index on each axis
    # "data", "fsdp", "tp" and "dp" (data x fsdp): this rank's group of each,
    # None where the axis has one member
    groups: Dict[str, Optional[dist.ProcessGroup]] = dataclasses.field(compare=False)

    def size(self, axis: str) -> int:
        if axis == "dp":
            return self.shape[0] * self.shape[1]
        return self.shape[AXES.index(axis)]

    def index(self, axis: str) -> int:
        if axis == "dp":
            return self.coords[0] * self.shape[1] + self.coords[1]
        return self.coords[AXES.index(axis)]

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.groups[axis]


def mesh_shape(world: int, data: int = -1, fsdp: int = 1, tp: int = 1) -> Tuple[int, int, int]:
    """The (data, fsdp, tp) sizes for `world` processes; data=-1 takes what
    fsdp x tp leaves."""
    if data == -1:
        if world % (fsdp * tp):
            raise ValueError(f"{world} processes do not split into fsdp {fsdp} x tp {tp}")
        data = world // (fsdp * tp)
    if data * fsdp * tp != world:
        raise ValueError(f"mesh {data}x{fsdp}x{tp} != {world} processes")
    return data, fsdp, tp


def make_mesh(data: int = -1, fsdp: int = 1, tp: int = 1) -> Mesh:
    """The mesh over the process group (one process without one). Every
    process must call it with the same sizes: it creates every group of
    every axis, in one order, as `torch.distributed.new_group` requires."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = mesh_shape(world, data, fsdp, tp)
    nd, nf, nt = shape
    coords = (rank // (nf * nt), rank // nt % nf, rank % nt)

    def ranks_of(fixed: Dict[int, int]):
        """Ranks whose coordinates match `fixed` (axis -> index)."""
        grid = itertools.product(range(nd), range(nf), range(nt))
        return [(d * nf + f) * nt + t for d, f, t in grid
                if all((d, f, t)[a] == i for a, i in fixed.items())]

    groups: Dict[str, Optional[dist.ProcessGroup]] = {}
    for name, axes in (("data", (0,)), ("fsdp", (1,)), ("tp", (2,)), ("dp", (0, 1))):
        if all(shape[a] == 1 for a in axes):
            groups[name] = None
            continue
        others = [a for a in range(3) if a not in axes]
        for idx in itertools.product(*(range(shape[a]) for a in others)):
            members = ranks_of(dict(zip(others, idx)))
            group = dist.new_group(members)
            if rank in members:
                groups[name] = group
    return Mesh(shape, coords, groups)
