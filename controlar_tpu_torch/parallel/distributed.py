"""Process-group set-up: torchrun's environment, SLURM's, or explicit
arguments (the JAX package's `parallel/distributed.py`, whose docstring cites
the reference's env://-or-SLURM rendezvous).

`init()` reads, in this order:

- torchrun's RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR / MASTER_PORT;
- SLURM's SLURM_PROCID, SLURM_NTASKS and SLURM_LOCALID, with the
  coordinator from the arguments, MASTER_ADDR / MASTER_PORT or
  SLURM_LAUNCH_NODE_IPADDR (port 29500);
- the explicit arguments (the CLI's --dist-coordinator host:port,
  --dist-num-processes, --dist-process-id).

In one process it does nothing. It takes NCCL when a card is present (after
`torch.cuda.set_device(local_rank)`) and gloo on the CPU. Unlike the JAX
package, which warns and goes on in one process when its rendezvous fails,
a failed rendezvous raises here.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

DEFAULT_PORT = 29500


def _from_env(coordinator_address: Optional[str]) -> Optional[Tuple[int, int, int, str]]:
    """-> (rank, world size, local rank, host:port) from torchrun's or
    SLURM's environment, or None when neither is set."""
    env = os.environ
    if "RANK" in env and "WORLD_SIZE" in env:
        addr = coordinator_address or (f"{env.get('MASTER_ADDR', '127.0.0.1')}:"
                                       f"{env.get('MASTER_PORT', DEFAULT_PORT)}")
        return int(env["RANK"]), int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", 0)), addr
    if "SLURM_PROCID" in env and "SLURM_NTASKS" in env:
        host = env.get("MASTER_ADDR") or env.get("SLURM_LAUNCH_NODE_IPADDR")
        addr = coordinator_address or (host and f"{host}:{env.get('MASTER_PORT', DEFAULT_PORT)}")
        if not addr:
            raise RuntimeError("SLURM run without a coordinator: set MASTER_ADDR or pass "
                               "--dist-coordinator host:port")
        return (int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", 0)), addr)
    return None


def init(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
         process_id: Optional[int] = None) -> None:
    """Join the process group when this is one of several processes; see the
    module docstring. Does nothing when the group exists already."""
    if dist.is_initialized():
        return
    found = _from_env(coordinator_address)
    if found is None:
        if num_processes is None and coordinator_address is None and process_id is None:
            return
        if num_processes is None or coordinator_address is None or process_id is None:
            raise ValueError("explicit rendezvous needs --dist-coordinator host:port, "
                             "--dist-num-processes and --dist-process-id together")
        found = (process_id, num_processes, process_id, coordinator_address)
    rank_, world, local_rank, addr = found
    if world == 1:
        return
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        backend = "nccl"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{addr}", world_size=world, rank=rank_)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return rank() == 0
