"""Data parallelism over a ``torch.distributed`` process group: the
rendezvous, and the collectives of the train step, each one counted.

Counterpart of the data-parallel part of ``picklebot_tpu/parallel/mesh.py``
(``init_multihost``; the JAX package's 'data' mesh axis becomes the
process group, one rank per card) and of ``picklebot_tpu/utils/
collectives.py``, which counts the collectives of the compiled JAX step
by kind. Here every helper below adds its call to ``COUNTS[kind]``:
``count`` calls and ``bytes`` of the logical RESULT tensor, as that module
defines them (an all-reduce of P bytes counts P, a reduce-scatter of P
bytes over n ranks P/n, an all-gather to P bytes P). A ring's wire bytes
are a factor of those that the caller applies.

  * ``init_distributed(coordinator=None, backend=None, device="cuda")``:
    a rendezvous from torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit
    ``host:port`` (rank and world from the arguments or those
    variables); a no-op when neither is there. The backend is ``nccl``
    for a card and ``gloo`` for the CPU unless named. ``device="cuda"``
    binds ``cuda:LOCAL_RANK``; an explicit ``cuda:N`` binds that card
    (two ranks on one card: ``gloo``, since NCCL refuses a card twice).
  * ``rank()``, ``world()``, ``is_main()``, ``distributed()``: 0, 1,
    True and False without a process group.
  * The collectives: ``all_reduce_sum_``, ``all_reduce_mean_`` (a list of
    tensors through one flat f32 bucket: sum, then / world),
    ``reduce_scatter`` and ``all_gather`` of flat tensors,
    ``rank_slices`` (tensors stacked by rank), ``broadcast_int``,
    ``min_int``, ``barrier``. ``gloo`` takes all of them on CUDA tensors
    too (torch 2.11 on an H100), which is how two ranks share one card:
    NCCL refuses a card twice.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "broadcast")
COUNTS = {kind: {"count": 0, "bytes": 0} for kind in KINDS}


def reset_counts() -> None:
    for c in COUNTS.values():
        c.update(count=0, bytes=0)


def counts() -> dict:
    """A copy of ``COUNTS``."""
    return {kind: dict(c) for kind, c in COUNTS.items()}


def _count(kind: str, t: torch.Tensor) -> None:
    COUNTS[kind]["count"] += 1
    COUNTS[kind]["bytes"] += t.numel() * t.element_size()


def _rendezvous_set() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_distributed(coordinator: Optional[str] = None,
                     backend: Optional[str] = None, device="cuda",
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> torch.device:
    """Join the process group and return this rank's device. With
    ``coordinator`` (``host:port``) the rendezvous is there, with rank and
    world from the arguments or ``RANK`` / ``WORLD_SIZE``; without one,
    torchrun's variables (``env://``); with neither, no group is made.
    Joining a second time returns the device only."""
    from picklebot_tpu_torch.utils.devices import resolve_device
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = resolve_device(str(device))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized() or (coordinator is None
                                 and not _rendezvous_set()):
        return device
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                      else world_size)
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                rank=rank, world_size=world_size)
    return device


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main() -> bool:
    return rank() == 0


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """In place: ``t`` <- the sum of every rank's ``t``."""
    if distributed():
        dist.all_reduce(t)
        _count("all-reduce", t)
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor]) -> None:
    """In place: each tensor <- its mean over the ranks, through one flat
    f32 bucket (the sum, then / world, as the JAX ``pmean``)."""
    if not distributed() or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_sum_(flat).div_(world())
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view(t.shape))
        offset += n


def reduce_scatter(flat: torch.Tensor) -> torch.Tensor:
    """(world * c,) -> (c,): this rank's chunk of the sum over ranks."""
    n = world()
    if not distributed():
        return flat.clone()
    out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat.contiguous())
    _count("reduce-scatter", out)
    return out


def all_gather(flat: torch.Tensor) -> torch.Tensor:
    """(c,) -> (world * c,): every rank's chunk, in rank order."""
    if not distributed():
        return flat.clone()
    out = torch.empty(world() * flat.numel(), dtype=flat.dtype,
                      device=flat.device)
    with warnings.catch_warnings():     # deprecated, not gone, past 2.11
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, flat.contiguous())
    _count("all-gather", out)
    return out


def _int_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank ``src``'s ``value`` on every rank."""
    if not distributed():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_int_device())
    dist.broadcast(t, src)
    _count("broadcast", t)
    return int(t.item())


def min_int(value: int) -> int:
    """The smallest of every rank's ``value``."""
    if not distributed():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=_int_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    _count("all-reduce", t)
    return int(t.item())


def barrier() -> None:
    if distributed():
        dist.barrier()


def rank_slices(tensors: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every rank's ``tensors`` stacked on a new leading axis (n, ...):
    one all-gather per dtype, over the tensors flattened into a bucket."""
    n = world()
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        stacked = all_gather(flat).view(n, -1)
        offset = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = stacked[:, offset:offset + k].reshape(
                (n,) + tuple(tensors[i].shape)).clone()
            offset += k
    return out
