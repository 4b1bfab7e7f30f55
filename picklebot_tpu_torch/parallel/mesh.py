"""The process group as a mesh of named axes, and the collectives of the
train step, each one counted.

Counterpart of ``picklebot_tpu/parallel/mesh.py`` (``make_mesh``,
``init_multihost``) and of ``picklebot_tpu/utils/collectives.py``, which
counts the collectives of the compiled JAX step by kind. Here every
helper below adds its call to ``COUNTS[kind]``: ``count`` calls and
``bytes`` of the logical RESULT tensor, as that module defines them (an
all-reduce of P bytes counts P, a reduce-scatter of P bytes over n ranks
P/n, an all-gather to P bytes P, a collective-permute the P bytes it
receives). A ring's wire bytes are a factor of those that the caller
applies.

  * ``init_distributed(coordinator=None, backend=None, device="cuda")``:
    a rendezvous from torchrun's variables (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) or from an explicit
    ``host:port`` (rank and world from the arguments or those
    variables); a no-op when neither is there. The backend is ``nccl``
    for a card and ``gloo`` for the CPU unless named. ``device="cuda"``
    binds ``cuda:LOCAL_RANK``; an explicit ``cuda:N`` binds that card
    (two ranks on one card: ``gloo``, since NCCL refuses a card twice).
    The process leaves the group at exit (``shutdown``).
  * ``init_mesh(model=1, seq=1, pipe=1, expert=1)``: the ranks as the
    JAX mesh's ('data', 'pipe', 'seq', 'expert', 'model') devices,
    data-major with 'model' innermost, so global rank r holds what device
    r of ``make_mesh`` holds; data = world / (pipe * seq * expert *
    model).
    Every rank builds every axis's subgroups, in the same order. An axis
    of size 1 has no group (its collectives are the identity and count
    nothing); an axis that spans the world is the default group, so at
    every other degree 1 'data' is exactly the group of plain data
    parallelism. ``axis_size``, ``axis_index``: 1 and 0 for an axis not
    in the mesh; before ``init_mesh`` 'data' is the world.
  * ``rank()``, ``world()``, ``is_main()``, ``distributed()``: 0, 1,
    True and False without a process group.
  * The collectives, each over ``group`` (an axis name, or None for the
    world): ``all_reduce_sum_``, ``all_reduce_mean_`` (a list of tensors
    through one flat f32 bucket: sum, then / the group's size),
    ``reduce_scatter`` and ``all_gather`` of flat tensors, ``all_to_all``
    (split on one dim, the pieces exchanged, concatenated on another: the
    JAX ``all_to_all(tiled=True)``), ``rank_slices`` (tensors stacked by
    rank), ``ppermute`` (to the next rank of the axis, from the previous
    one), ``broadcast_int``, ``min_int``, ``barrier``. ``gloo`` takes all of them on CUDA tensors too (torch
    2.11 on an H100), which is how two ranks share one card (NCCL
    refuses a card twice), except point-to-point messages: gloo's
    ``send``/``recv`` read host memory, so ``ppermute`` stages a CUDA
    tensor through the host under gloo.
"""

from __future__ import annotations

import atexit
import os
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "broadcast",
         "collective-permute", "all-to-all")
AXES = ("data", "pipe", "seq", "expert", "model")
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
    atexit.register(shutdown)
    return device


def shutdown() -> None:
    """Leave the process group, if this process is in one. A process that
    joined through ``init_distributed`` calls it at exit, whatever the
    path out: a group left to the interpreter's teardown can abort the
    process (``terminate called without an active exception``, SIGABRT)
    when its threads are destroyed still joinable."""
    global _MESH_SHAPE
    _MESH.clear()
    _MESH_SHAPE = None
    if distributed():
        dist.destroy_process_group()


def distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if distributed() else 0


def world() -> int:
    return dist.get_world_size() if distributed() else 1


def is_main() -> bool:
    return rank() == 0


class _Axis:
    """One mesh axis as this rank sees it: its size, this rank's index on
    it, the global ranks of this rank's group (in axis order) and the
    process group (None: the default group)."""

    def __init__(self, size: int, index: int, ranks: Sequence[int],
                 group=None):
        self.size, self.index, self.ranks, self.group = (
            int(size), int(index), list(ranks), group)


_MESH: Dict[str, _Axis] = {}
_MESH_SHAPE: Optional[Tuple[int, ...]] = None


def mesh_coords(r: int, shape: Dict[str, int]) -> Dict[str, int]:
    """Global rank ``r``'s position on each axis of a mesh of ``shape``
    ({axis: size}, every axis of ``AXES``), data-major with 'model'
    innermost: the order of ``make_mesh``'s device array."""
    coords = {}
    for axis in reversed(AXES):
        coords[axis] = r % shape[axis]
        r //= shape[axis]
    return coords


def init_mesh(model: int = 1, seq: int = 1, pipe: int = 1,
              expert: int = 1) -> Dict[str, int]:
    """Lay the process group out as the mesh (data, pipe, seq, expert,
    model) and build every subgroup; returns {axis: size}. Every rank must
    call it, with the same degrees. Called again with the same degrees it
    keeps the groups it built."""
    global _MESH_SHAPE
    n = world()
    inner = model * seq * pipe * expert
    if min(model, seq, pipe, expert) < 1 or n % inner:
        raise ValueError(
            f"model_parallel={model} x sequence_parallel={seq} x "
            f"pipeline_parallel={pipe} x expert_parallel={expert} must "
            f"divide the {n} rank(s) of the process group")
    shape = {"data": n // inner, "pipe": pipe, "seq": seq, "expert": expert,
             "model": model}
    key = tuple(shape[a] for a in AXES)
    if key == _MESH_SHAPE and _MESH:
        return dict(shape)
    me = rank()
    coords = [mesh_coords(r, shape) for r in range(n)]
    _MESH.clear()
    for axis in AXES:
        size = shape[axis]
        mine = coords[me]
        ranks = [r for r in range(n)
                 if all(coords[r][a] == mine[a] for a in AXES if a != axis)]
        group = None
        if 1 < size < n:
            # every rank builds every group of the axis, in the same order
            for first in range(n):
                if coords[first][axis] != 0:
                    continue
                members = [r for r in range(n) if all(
                    coords[r][a] == coords[first][a]
                    for a in AXES if a != axis)]
                g = dist.new_group(members)
                if me in members:
                    group = g
        _MESH[axis] = _Axis(size, mine[axis], ranks, group)
    _MESH_SHAPE = key
    return dict(shape)


def _axis(name: Optional[str]) -> _Axis:
    if name is None or (name == "data" and not _MESH):
        return _Axis(world(), rank(), range(world()))
    if name not in AXES:
        raise ValueError(f"unknown mesh axis {name!r} (valid: {AXES})")
    return _MESH.get(name) or _Axis(1, 0, [rank()])


def axis_size(name: Optional[str] = None) -> int:
    """The size of mesh axis ``name`` (None: the world)."""
    return _axis(name).size


def axis_index(name: Optional[str] = None) -> int:
    """This rank's index on mesh axis ``name`` (None: its global rank)."""
    return _axis(name).index


def _group(name: Optional[str]):
    """(process group or None for the default, size, whether a collective
    runs): it runs under a process group whenever the axis has more than
    one rank or is the whole world (so a world of 1 calls and counts its
    collectives as plain data parallelism always has)."""
    ax = _axis(name)
    return ax.group, ax.size, distributed() and (ax.size > 1
                                                 or world() == 1)


def all_reduce_sum_(t: torch.Tensor,
                    group: Optional[str] = None) -> torch.Tensor:
    """In place: ``t`` <- the sum of ``t`` over the group's ranks."""
    pg, _, active = _group(group)
    if active:
        dist.all_reduce(t, group=pg)
        _count("all-reduce", t)
    return t


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Optional[str] = None) -> None:
    """In place: each tensor <- its mean over the group's ranks, through
    one flat f32 bucket (the sum, then / size, as the JAX ``pmean``)."""
    _, n, active = _group(group)
    if not active or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    all_reduce_sum_(flat, group).div_(n)
    offset = 0
    for t in tensors:
        k = t.numel()
        t.copy_(flat[offset:offset + k].view(t.shape))
        offset += k


def reduce_scatter(flat: torch.Tensor,
                   group: Optional[str] = None) -> torch.Tensor:
    """(n * c,) -> (c,): this rank's chunk of the sum over the group's n
    ranks."""
    pg, n, active = _group(group)
    if not active:
        return flat.clone()
    out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                      device=flat.device)
    dist.reduce_scatter_tensor(out, flat.contiguous(), group=pg)
    _count("reduce-scatter", out)
    return out


def all_gather(flat: torch.Tensor,
               group: Optional[str] = None) -> torch.Tensor:
    """(c,) -> (n * c,): every one of the group's n ranks' chunk, in axis
    order."""
    pg, n, active = _group(group)
    if not active:
        return flat.clone()
    out = torch.empty(n * flat.numel(), dtype=flat.dtype,
                      device=flat.device)
    with warnings.catch_warnings():     # deprecated, not gone, past 2.11
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, flat.contiguous(), group=pg)
    _count("all-gather", out)
    return out


def ppermute(tensors: Sequence[torch.Tensor], group: str,
             shift: int = 1) -> List[torch.Tensor]:
    """Each tensor sent to the rank ``shift`` places on along axis
    ``group`` (cyclically) and replaced by the one from ``shift`` places
    back: the JAX ``ppermute`` with perm [(i, (i + shift) % n)]. One
    batch of sends and receives; each received tensor counts as one
    collective-permute of its bytes."""
    ax = _axis(group)
    n = ax.size
    if not distributed() or n == 1 or shift % n == 0:
        return [t.clone() for t in tensors]
    dst = ax.ranks[(ax.index + shift) % n]
    src = ax.ranks[(ax.index - shift) % n]
    staged = (dist.get_backend() == "gloo"
              and any(t.is_cuda for t in tensors))
    sends = [t.detach().contiguous() for t in tensors]
    if staged:
        sends = [t.cpu() for t in sends]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, dst, group=ax.group) for t in sends]
           + [dist.P2POp(dist.irecv, t, src, group=ax.group)
              for t in recvs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    out = []
    for t, r in zip(tensors, recvs):
        _count("collective-permute", r)
        out.append(r.to(t.device) if staged else r)
    return out


def all_to_all(x: torch.Tensor, group: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``x`` cut into the group's n pieces along ``split_dim``, piece j
    sent to the j-th rank of the axis, and the n pieces this rank
    receives concatenated along ``concat_dim`` in axis order: the JAX
    ``all_to_all(split_axis, concat_axis, tiled=True)``. One collective;
    it counts the bytes of the result. The identity at an axis of one
    rank."""
    pg, n, _ = _group(group)
    if not distributed() or n == 1:
        return x.clone()
    if x.shape[split_dim] % n:
        raise ValueError(f"a dim of {x.shape[split_dim]} does not split "
                         f"over the {n} ranks of '{group}'")
    xs = x.movedim(split_dim, 0)
    xs = xs.reshape((n, xs.shape[0] // n) + tuple(xs.shape[1:]))
    xs = xs.contiguous()
    out = torch.empty_like(xs)
    dist.all_to_all_single(out, xs, group=pg)
    # out[j]: rank j's piece for this rank, its split dim first
    pieces = [p.movedim(0, split_dim) for p in out.unbind(0)]
    result = torch.cat(pieces, dim=concat_dim)
    _count("all-to-all", result)
    return result


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


def rank_slices(tensors: List[torch.Tensor],
                group: Optional[str] = None) -> List[torch.Tensor]:
    """Every rank's ``tensors`` stacked on a new leading axis (n, ...),
    over the group's n ranks: one all-gather per dtype, over the tensors
    flattened into a bucket."""
    n = axis_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        stacked = all_gather(flat, group).view(n, -1)
        offset = 0
        for i in idx:
            k = tensors[i].numel()
            out[i] = stacked[:, offset:offset + k].reshape(
                (n,) + tuple(tensors[i].shape)).clone()
            offset += k
    return out
