"""Pipeline parallelism (PP): a GPipe microbatch schedule over a mesh axis.

Counterpart of ``picklebot_tpu/parallel/pipeline.py``. ``P`` stages each
own ``L/P`` consecutive layers of a depth-``L`` homogeneous stack (every
rank holds every layer's parameters; a rank runs only its own). The batch
splits into ``M`` microbatches, and at tick ``t`` of ``M + P - 1``:

  stage 0 feeds microbatch ``t`` (its last one again once ``t >= M``),
  stage ``r`` applies its layers to the activation it received from
  stage ``r-1`` (zeros, or a microbatch that no stage retires, during the
  fill and drain ticks),
  stage ``P-1`` retires microbatch ``t-(P-1)``,

and ``mesh.ppermute`` moves each stage's output to the next stage (no hop
after the last tick, whose hop nobody reads). The schedule is uniform:
every rank runs its stage on every tick, so every rank builds the same
autograd graph, and the backward's reverse hops pair up tick by tick on
all ranks (a rank that skipped its idle ticks would build another graph
and could wait in its backward for a hop no other rank sends).

Three things make every rank end the backward with the one-process
gradient, where the JAX function leaves stage 0 with P times the true
gradient upstream of the stack and the other stages with none (its exit
``psum`` transposes to a second sum of the already-replicated cotangent):

  * the stack's input enters through Megatron's f over the axis
    (``megatron.tp_copy_in``: identity forward, all-reduce backward); only
    stage 0 reads it, so the sum hands stage 0's gradient to every rank;
  * the output leaves through Megatron's g (``tp_reduce_out``): the last
    stage's outputs, zeros elsewhere, summed forward, and the replicated
    cotangent passed on unchanged backward;
  * each rank's stack parameters have gradients for its own layers only:
    ``pp_sync_grads`` sums them over the axis in the train step, for the
    stacks whose last forward ran pipelined (``pp_engaged``).

With dropout off the pipelined stack is the layer loop, up to the f32
reassociation of a microbatched matmul (attention, FFN, LayerNorm and
residuals are per sample). With dropout on, the caller keys the masks on
(layer, microbatch), which is the JAX stream's class of divergence from
the one-process stream.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from picklebot_tpu_torch.parallel import mesh
from picklebot_tpu_torch.parallel.megatron import tp_copy_in, tp_reduce_out
from picklebot_tpu_torch.parallel.sequence import sum_engaged_grads

__all__ = ["gpipe_apply", "pp_sync_grads"]


class _Hop(torch.autograd.Function):
    """One stage hop: forward to the next rank of the axis, the gradient
    back to the previous one."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return mesh.ppermute([x], axis, 1)[0]

    @staticmethod
    def backward(ctx, g):
        return mesh.ppermute([g.contiguous()], ctx.axis, -1)[0], None


def gpipe_apply(layer_fn: Callable, layers: Sequence, x: torch.Tensor,
                axis: str, microbatches: int) -> torch.Tensor:
    """Run a homogeneous layer stack as a GPipe pipeline over ``axis``.

    layer_fn(layer, layer_idx, mb_idx, h) -> h
        applies ONE layer; ``layer_idx`` (global) and ``mb_idx`` may key
        its dropout masks.
    layers : the whole stack, depth L (stage r runs rows r*L/P..).
    x : (B, ...) activations, the same on every rank of the axis.
    microbatches : M; must divide B.

    Returns (B, ...) outputs, the same on every rank of the axis."""
    n_stages, rank = mesh.axis_size(axis), mesh.axis_index(axis)
    depth = len(layers)
    if depth % n_stages:
        raise ValueError(f"stack depth {depth} must divide over "
                         f"{n_stages} pipeline stages")
    m = microbatches
    if x.shape[0] % m:
        raise ValueError(f"batch {x.shape[0]} must divide into {m} "
                         "microbatches")
    l_local = depth // n_stages
    first = torch.tensor(rank == 0, device=x.device)
    last = torch.tensor(rank == n_stages - 1, device=x.device)
    xs = tp_copy_in(x, axis).chunk(m)
    state = torch.zeros_like(xs[0])
    ticks = m + n_stages - 1
    retired = []
    for t in range(ticks):
        # where(), not a Python branch: every rank keeps both inputs in
        # its graph, so the hops' and the entry's backward run everywhere
        h = torch.where(first, xs[min(t, m - 1)], state)
        mb = min(max(t - rank, 0), m - 1)
        for i in range(l_local):
            li = rank * l_local + i
            h = layer_fn(layers[li], li, mb, h)
        if t >= n_stages - 1:
            retired.append(h)
        if t < ticks - 1:
            state = _Hop.apply(h, axis)
    out = torch.cat(retired)
    return tp_reduce_out(torch.where(last, out, torch.zeros_like(out)),
                         axis)


def pp_sync_grads(model, axis: str = "pipe") -> None:
    """The gradients of the stacks whose last forward ran pipelined
    (``pp_engaged``), summed over ``axis`` in one flat f32 all-reduce:
    each rank holds its own stage's layers' gradients and zeros for the
    rest. A no-op where no stack engaged or the axis has one rank."""
    sum_engaged_grads(model, axis, "pp_engaged")
