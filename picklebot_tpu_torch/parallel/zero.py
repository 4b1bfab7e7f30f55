"""ZeRO: the optimizer state, and at stage 3 the parameters, sharded over
the data-parallel ranks.

Counterpart of ``picklebot_tpu/parallel/zero.py``, with its layout and
its function names. Each parameter is flattened and zero-padded to
``n * ceil(size / n)``; rank r owns ``[r * chunk, (r + 1) * chunk)``.
The optimizer is built on the rank's (chunk,) slices (``zero_optimizer``),
so AdamW8bit's ``min_8bit_size`` and its 256-blocks are decided per
chunk, as the JAX package inits on (chunk,) prototypes.

  * Stage 1 (``zero_update``): the summed gradients are reduce-scattered
    (one flat bucket whose row r holds every parameter's chunk r) and
    divided by n, the global-norm clip works on the slices (each rank's
    sum of squares, added over the ranks: ``_shard_and_clip_grads``,
    shared with stage 3), the optimizer updates the rank's slices, and
    an all-gather writes the new parameters back on every rank.
  * Stage 3 (``zero3_update``): the parameters (and the EMA) are kept as
    the rank's chunks between steps; ``zero3_gather_params`` all-gathers
    them at the top of the step (a parameter's ``.data`` is empty at
    rest) and ``zero3_release_params`` drops them after it, with no
    trailing all-gather. The arithmetic is stage 1's, so stage 3 equals
    stage 1, and both equal plain data parallelism in f32 (the JAX
    package's ``tests/test_zero.py`` and ``tests/test_zero3.py``).
  * Snapshots hold full leaves and the optimizer state in the (n, chunk)
    rank-stack layout (``gather_optimizer_state``); ``zero_degree_of``
    reads the degree back from the shapes, and ``zero_reshard`` converts
    between degrees (and to and from the replicated layout): exact for
    f32 moments, 8-bit ones decoded and requantized per the new chunks.

Every collective goes through ``parallel/mesh.py`` and is counted there.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.train.optim import (dequantize_signed,
                                             dequantize_unsigned,
                                             quantize_signed,
                                             quantize_unsigned)


def _chunk(size: int, n: int) -> int:
    return -(-size // n)


def _padded(t: torch.Tensor, n: int) -> torch.Tensor:
    """t flattened and zero-padded to n * chunk, viewed (n, chunk)."""
    flat = t.detach().reshape(-1)
    c = _chunk(flat.numel(), n)
    return F.pad(flat, (0, n * c - flat.numel())).view(n, c)


class ZeroLayout:
    """The ZeRO layout of ``model``'s parameters over ``n`` ranks as seen
    from ``rank``: ``shards[i]`` is the rank's f32 (chunk,) slice of
    parameter i (every parameter at stage 3, where the slices are the
    parameters' values between steps; the trainable ones are what the
    optimizer steps). Build it after the model is on its device and holds
    its weights; at stage 3 it releases the full parameters."""

    def __init__(self, model, n: int, rank: int, stage: int = 1):
        if stage not in (1, 3):
            raise ValueError(f"ZeRO stage must be 1 or 3, got {stage}")
        self.n, self.rank, self.stage = int(n), int(rank), stage
        named = list(model.named_parameters())
        self.names = [k for k, _ in named]
        self.params = [p for _, p in named]
        self.shapes = [tuple(p.shape) for p in self.params]
        self.sizes = [p.numel() for p in self.params]
        self.chunks = [_chunk(s, self.n) for s in self.sizes]
        self.trainable = [i for i, p in enumerate(self.params)
                          if p.requires_grad]
        self.shards = [self.shard_value(p, i).float().clone()
                       .requires_grad_(p.requires_grad)
                       for i, p in enumerate(self.params)]
        if stage == 3:
            zero3_release_params(self)

    def shard_value(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's chunk of a full tensor shaped like parameter i."""
        return _padded(t, self.n)[self.rank]

    def opt_params(self) -> List[torch.Tensor]:
        """The slices the optimizer steps (the trainable parameters')."""
        return [self.shards[i] for i in self.trainable]

    def full(self, chunks: List[torch.Tensor],
             which: Optional[List[int]] = None) -> List[torch.Tensor]:
        """Every rank's ``chunks`` (this rank's chunk of each parameter in
        ``which``, default all) -> the full tensors: one all-gather."""
        which = range(len(self.params)) if which is None else which
        stacked = mesh.all_gather(torch.cat([c.detach().reshape(-1)
                                             for c in chunks]))
        stacked = stacked.view(self.n, -1)
        out, offset = [], 0
        for i in which:
            c = self.chunks[i]
            out.append(stacked[:, offset:offset + c].reshape(-1)
                       [:self.sizes[i]].view(self.shapes[i]))
            offset += c
        return out


@contextlib.contextmanager
def gathered(layout: Optional[ZeroLayout]):
    """Within the block the parameters are full (for an eval, a snapshot
    or the final weights): at stage 3 gathered for it and released after;
    without ZeRO-3 (``layout`` None or stage 1) they always are."""
    if layout is None or layout.stage != 3:
        yield
        return
    zero3_gather_params(layout)
    try:
        yield
    finally:
        zero3_release_params(layout)


def zero_optimizer(optimizer_cls, layout: ZeroLayout, **kwargs):
    """``optimizer_cls`` (``AdamW`` / ``AdamW8bit``) over the rank's
    slices: its moments are (chunk,) per trainable parameter."""
    return optimizer_cls(layout.opt_params(), **kwargs)


def _shard_and_clip_grads(layout: ZeroLayout, max_grad_norm=None):
    """Reduce-scatter the summed gradients to this rank's slices (sum / n,
    the DDP mean) and optionally clip them by the global norm, whose
    square is each rank's sum over its slices added over the ranks (the
    pad zeros add nothing). Shared by stages 1 and 3, which keeps them
    bit-equal."""
    n = layout.n
    cols = []
    for i in layout.trainable:
        g = layout.params[i].grad
        g = (torch.zeros(layout.sizes[i], device=layout.shards[i].device)
             if g is None else g.float())
        cols.append(_padded(g, n))
    mine = mesh.reduce_scatter(torch.cat(cols, dim=1).reshape(-1)).div_(n)
    g_sh = list(torch.split(mine, [layout.chunks[i]
                                   for i in layout.trainable]))
    grad_norm = None
    if max_grad_norm is not None:
        local_sq = torch.zeros(1, device=mine.device)
        for g in g_sh:
            local_sq += g.pow(2).sum()
        grad_norm = torch.sqrt(mesh.all_reduce_sum_(local_sq))[0]
        scale = torch.clamp(max_grad_norm / (grad_norm + 1e-6), max=1.0)
        for g in g_sh:
            g.mul_(scale)
    return g_sh, grad_norm


def _step_slices(layout, optimizer, lr, max_grad_norm):
    g_sh, grad_norm = _shard_and_clip_grads(layout, max_grad_norm)
    for s, g in zip(layout.opt_params(), g_sh):
        s.grad = g
    optimizer.step(lr)
    return grad_norm


def zero_update(layout: ZeroLayout, optimizer, lr: float,
                max_grad_norm=None):
    """The stage-1 update after the microbatches: the parameters' summed
    gradients (``.grad``, this rank's) -> reduce-scatter, clip, the
    optimizer on the rank's slices, all-gather into the parameters.
    Returns the global gradient norm (or None without clipping)."""
    with torch.no_grad():
        for i in layout.trainable:
            layout.shards[i].copy_(
                layout.shard_value(layout.params[i], i))
    grad_norm = _step_slices(layout, optimizer, lr, max_grad_norm)
    with torch.no_grad():
        full = layout.full(layout.opt_params(), layout.trainable)
        for i, value in zip(layout.trainable, full):
            layout.params[i].copy_(value)
    return grad_norm


def zero3_update(layout: ZeroLayout, optimizer, lr: float,
                 max_grad_norm=None):
    """The stage-3 update: as ``zero_update``, but the slices are the
    parameters' stored values, and nothing is gathered after it (the next
    step's ``zero3_gather_params`` does that)."""
    return _step_slices(layout, optimizer, lr, max_grad_norm)


def zero3_gather_params(layout: ZeroLayout) -> None:
    """Every parameter <- its full value, all-gathered from the ranks'
    chunks (one bucket)."""
    with torch.no_grad():
        for p, value in zip(layout.params, layout.full(layout.shards)):
            p.data = value.to(p.dtype)


def zero3_release_params(layout: ZeroLayout) -> None:
    """Drop the full parameters and their gradients: only the rank's
    chunks stay (``layout.shards``)."""
    for p in layout.params:
        p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        p.grad = None


def zero3_unshard_params(layout: ZeroLayout, chunks) -> dict:
    """{name: full tensor} from every rank's ``chunks`` (one per
    parameter, e.g. the stage-3 EMA's)."""
    return dict(zip(layout.names, layout.full(chunks)))


# --------------------------------------------------------------------------
# optimizer state: the rank-stack layout of snapshots, and resharding
# --------------------------------------------------------------------------

def _parts(st):
    return list(st) if isinstance(st, tuple) else [st]


def gather_optimizer_state(layout: ZeroLayout, optimizer) -> dict:
    """Every rank's optimizer state stacked into the JAX package's
    layout: f32 moments (n, chunk), 8-bit ones (n, blocks, 256) codes and
    (n, blocks, 1) scales, ``shapes`` the full parameters'. A collective
    (one all-gather per dtype); host copies."""
    st = optimizer.state_dict()
    flat = [t for part in ("m", "v") for s in st[part] for t in _parts(s)]
    stacks = iter(t.cpu() for t in mesh.rank_slices(
        [t.to(layout.shards[0].device) for t in flat]))

    def restack(states):
        return [tuple(next(stacks) for _ in s) if isinstance(s, tuple)
                else next(stacks) for s in states]
    m, v = restack(st["m"]), restack(st["v"])
    return {"steps": st["steps"], "m": m, "v": v,
            "shapes": [layout.shapes[i] for i in layout.trainable]}


def local_optimizer_state(layout: ZeroLayout, state: dict) -> dict:
    """A rank-stacked state (at this layout's degree) -> this rank's own,
    for ``optimizer.load_state_dict``."""
    def row(s):
        return (tuple(t[layout.rank] for t in s) if isinstance(s, tuple)
                else s[layout.rank])
    return {"steps": state["steps"], "m": [row(s) for s in state["m"]],
            "v": [row(s) for s in state["v"]],
            "shapes": [(layout.chunks[i],) for i in layout.trainable]}


def zero_degree_of(state: dict) -> int:
    """The ZeRO degree of an optimizer state (0 = replicated), by the JAX
    package's rule: an 8-bit moment is stacked iff its codes are 3-D; an
    f32 moment of a parameter that is not 2-D iff it is 2-D (a 2-D
    parameter's replicated moment and its stack can share a rank, so
    those are skipped)."""
    for shape, m in zip(state["shapes"], state["m"]):
        if isinstance(m, tuple):
            return int(m[0].shape[0]) if m[0].dim() == 3 else 0
        if len(shape) != 2:
            if m.dim() == len(shape):
                return 0
            if m.dim() == 2:
                return int(m.shape[0])
    raise ValueError(
        "could not determine the optimizer-state layout: every moment "
        "is shape-ambiguous (all parameters 2-D)")


def zero_reshard(optimizer, state: dict, n_new: int,
                 n_old: Optional[int] = None) -> dict:
    """An optimizer state (replicated or rank-stacked, as snapshots hold
    it) converted to degree ``n_new`` (<= 1: replicated); ``n_old`` is
    read from the state when not given. f32 moments move exactly (unpad,
    concatenate, re-chunk); 8-bit ones are decoded and requantized on the
    new chunks, and whether a tensor keeps 8-bit moments is decided
    again for the new chunk size by ``optimizer.quantizes``, as a fresh
    init would."""
    n_old = zero_degree_of(state) if n_old is None else n_old
    n_old = 0 if n_old <= 1 else int(n_old)
    n_new = 0 if n_new <= 1 else int(n_new)
    if n_old == n_new:
        return state

    def to_flat(shape, x, signed):
        size = math.prod(shape)
        deq = dequantize_signed if signed else dequantize_unsigned
        if isinstance(x, tuple):
            codes, scales = x
            if n_old:
                c = _chunk(size, n_old)
                flat = torch.cat([deq(codes[r], scales[r], (c,))
                                  for r in range(n_old)])
            else:
                flat = deq(codes, scales, (codes.numel(),))
            return flat[:size].float()
        return x.float().reshape(-1)[:size]

    def encode(shape, flat, signed):
        size = math.prod(shape)
        quant = quantize_signed if signed else quantize_unsigned
        if n_new:
            c = _chunk(size, n_new)
            padded = F.pad(flat, (0, n_new * c - size))
            if optimizer.quantizes(c):
                qs = [quant(padded[r * c:(r + 1) * c]) for r in range(n_new)]
                return (torch.stack([q for q, _ in qs]),
                        torch.stack([s for _, s in qs]))
            return padded.view(n_new, c).clone()
        if optimizer.quantizes(size):
            return quant(flat)
        return flat.reshape(shape).clone()

    def convert(part, signed):
        return [encode(shape, to_flat(shape, x, signed), signed)
                for shape, x in zip(state["shapes"], state[part])]

    return {"steps": state["steps"], "m": convert("m", True),
            "v": convert("v", False),
            "shapes": [tuple(s) for s in state["shapes"]]}
