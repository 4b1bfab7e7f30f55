"""Sequence parallelism (SP): the token-axis boundary operators.

Counterpart of ``picklebot_tpu/parallel/sequence.py``. A transformer
region runs on a 1/size block of the tokens per rank of the 'seq' axis,
and the network around it is replicated over 'seq':

  * ``sp_scatter_tokens``: enter the region. Forward, this rank's token
    block (a slice); backward, the blocks' gradients all-gathered into
    the full, replicated one (a plain slice would zero the gradient
    outside the block and the replicated upstream would drift apart).
  * ``sp_gather_tokens``: leave the region. Forward, the tiled
    all-gather; backward, this rank's block of the already-replicated
    gradient (the naive backward, a reduce-scatter, would scale it by the
    axis size).
  * ``sp_sync_grads``: the JAX ``sp_sync_param`` (Megatron's f on
    'seq') for the whole step. A parameter used inside the region gets,
    on each rank, only its own tokens' gradient, and the true one is
    their sum: one all-reduce-sum over 'seq' of exactly those
    parameters' gradients, after the last microbatch. A
    ``TransformerStack`` records in ``sp_engaged`` whether its last
    forward ran token-sharded; a stack that fell back to replicated
    execution (an indivisible token count) is not summed, which would
    double its gradients.
  * ``all_gather_tokens``: a tiled all-gather whose backward is the
    reduce-scatter, for tensors that are truly sharded (the K/V of
    attention with dropout, which every rank's queries read whole).

The token axis is -2 throughout, (..., N, D).
"""

from __future__ import annotations

import torch

from picklebot_tpu_torch.parallel import mesh


def _local_block(x: torch.Tensor, axis: str) -> torch.Tensor:
    n, size = x.shape[-2], mesh.axis_size(axis)
    if n % size:
        # every caller must check first (the TransformerStack falls back
        # to replicated execution): an uneven split would drop tokens
        raise ValueError(
            f"sequence parallelism needs the token count ({n}) divisible "
            f"by the '{axis}' axis size ({size})")
    n_local = n // size
    start = mesh.axis_index(axis) * n_local
    return x.narrow(-2, start, n_local)


def _gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    """(..., n, D) on each rank -> (..., size * n, D), blocks in axis
    order."""
    size = mesh.axis_size(axis)
    xt = x.movedim(-2, 0).contiguous()
    full = mesh.all_gather(xt.reshape(-1), axis).view(
        (size * xt.shape[0],) + tuple(xt.shape[1:]))
    return full.movedim(0, -2)


def _scatter_sum(g: torch.Tensor, axis: str) -> torch.Tensor:
    """(..., size * n, D) on each rank -> this rank's (..., n, D) block of
    the sum over the ranks."""
    size = mesh.axis_size(axis)
    gt = g.movedim(-2, 0).contiguous()
    local = mesh.reduce_scatter(gt.reshape(-1), axis).view(
        (gt.shape[0] // size,) + tuple(gt.shape[1:]))
    return local.movedim(0, -2)


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _local_block(x, axis).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _local_block(g, ctx.axis).contiguous(), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.axis), None


def sp_scatter_tokens(x: torch.Tensor, axis: str = "seq") -> torch.Tensor:
    """Replicated (..., N, D) -> this rank's (..., N/size, D) block."""
    return _Scatter.apply(x, axis)


def sp_gather_tokens(x: torch.Tensor, axis: str = "seq") -> torch.Tensor:
    """This rank's (..., N/size, D) block -> replicated (..., N, D)."""
    return _Gather.apply(x, axis)


def all_gather_tokens(x: torch.Tensor, axis: str = "seq") -> torch.Tensor:
    """Sharded (..., n, D) blocks -> (..., size * n, D) on every rank,
    with the reduce-scatter as backward."""
    return _AllGather.apply(x, axis)


def sp_sync_grads(model, axis: str = "seq") -> None:
    """The gradients of the trainable parameters of every module whose
    last forward ran token-sharded (``sp_engaged``), summed over
    ``axis`` in one flat f32 all-reduce. A no-op where no region engaged
    or the axis has one rank."""
    sum_engaged_grads(model, axis, "sp_engaged")


def sum_engaged_grads(model, axis: str, flag: str) -> None:
    """The gradients of the trainable parameters of every module whose
    attribute ``flag`` is true, summed over ``axis`` in one flat f32
    all-reduce (a parameter without one counts as zero). A no-op where no
    module is flagged or the axis has one rank."""
    if mesh.axis_size(axis) == 1:
        return
    params = list({id(p): p for m in model.modules()
                   if getattr(m, flag, False)
                   for p in m.parameters() if p.requires_grad}.values())
    if not params:
        return
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    mesh.all_reduce_sum_(flat, axis)
    offset = 0
    for g in grads:
        k = g.numel()
        g.copy_(flat[offset:offset + k].view(g.shape))
        offset += k
