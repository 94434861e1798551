"""Process groups and cross-process reductions.

Counterpart of ``sola_tpu/parallel/distributed.py``: the reference's
process-level sharding (N independent processes, each handling
``video_idx % n_pids == pid``, generate_tokens_grid.py:96) plus
cross-process metric sums for evaluation, on ``torch.distributed``.

``initialize`` takes JAX's arguments, or torchrun's environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``). The
backend is NCCL when every rank of the host has a card of its own and gloo
on the CPU; ranks that share a card must ask for gloo themselves (NCCL
refuses two ranks on one device), and no backend is ever swapped for
another. A rank's card is ``cuda:LOCAL_RANK % device_count``.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, TypeVar

import torch
import torch.distributed as dist

T = TypeVar("T")


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


process_count = _world_size


def rank_device(device="cuda") -> torch.device:
    """This rank's device for an entry point's ``device``: its own card
    (``cuda:LOCAL_RANK % device_count``) for a bare ``cuda``; any other
    device as given."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local_rank = int(os.environ.get("LOCAL_RANK", process_index()))
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def default_backend(device="cuda") -> str:
    """NCCL when each rank of this host has a card of its own, gloo for
    ranks on the CPU (``device``) or where there is no card; raises when
    ranks would share a card."""
    if torch.device(device).type != "cuda" or not torch.cuda.is_available():
        return "gloo"
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1")))
    if local_world > torch.cuda.device_count():
        raise RuntimeError(
            f"{local_world} ranks on {torch.cuda.device_count()} card(s): "
            f"NCCL takes one rank a card; pass backend='gloo' to share one")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None, device="cuda") -> bool:
    """Join the process group: ``coordinator_address`` ("host:port"),
    ``num_processes`` and ``process_id`` as ``jax.distributed.initialize``
    takes them, each read from torchrun's environment when not given;
    ``backend`` defaults to ``default_backend(device)``. A no-op for one
    process or an existing group. Returns whether a group of more than one
    process is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    world = int(num_processes if num_processes is not None
                else os.environ.get("WORLD_SIZE", 1))
    if world <= 1:
        return False
    rank = int(process_id if process_id is not None
               else os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    backend = backend or default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    return True


def collective_device() -> torch.device:
    """Where host values go for a collective: the rank's card under NCCL,
    the CPU under gloo."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return rank_device("cuda")
    return torch.device("cpu")


def shard_for_host(items: Sequence[T],
                   process_id: Optional[int] = None,
                   process_count: Optional[int] = None,
                   strided: bool = True) -> list[T]:
    """This process's share of a work list: ``items[pid::n]`` (the tokens
    CLIs' ``idx % n == pid``; ``strided`` is kept for call sites that name
    the prompts CLIs' slice, which is the same stride)."""
    pid = process_index() if process_id is None else process_id
    n = _world_size() if process_count is None else process_count
    if n <= 1:
        return list(items)
    return [x for i, x in enumerate(items) if i % n == pid]


def all_sum(metrics: dict) -> dict:
    """Sum scalar metrics over every process (float64, so counts stay
    exact); the identity for one process."""
    if _world_size() <= 1:
        return dict(metrics)
    keys = sorted(metrics)
    local = torch.tensor([float(metrics[k]) for k in keys],
                         dtype=torch.float64, device=collective_device())
    dist.all_reduce(local)
    return {k: float(v) for k, v in zip(keys, local.tolist())}


def verify_disjoint_coverage(n_items: int, process_count: int) -> bool:
    """The per-process shards form a disjoint union of the work list."""
    seen: list[int] = []
    for pid in range(process_count):
        seen.extend(i for i in range(n_items) if i % process_count == pid)
    return sorted(seen) == list(range(n_items))
