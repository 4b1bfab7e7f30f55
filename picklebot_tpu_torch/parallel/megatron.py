"""Megatron's f/g boundary operators for a region whose hidden width is
sharded over a mesh axis (tensor parallelism of MobileViT's FFNs), and the
TP layout of a state dict.

Counterpart of ``picklebot_tpu/parallel/megatron.py``:

  * ``tp_copy_in`` (Megatron's f): identity forward, all-reduce backward.
    The replicated residual stream enters the sharded region; its
    gradient is the sum of each shard's contribution.
  * ``tp_reduce_out`` (Megatron's g): all-reduce forward, identity
    backward. The shards' partial outputs sum over the axis. The naive
    backward of a forward all-reduce would all-reduce the replicated
    output gradient again and scale every gradient upstream by the axis
    size: the trap this pair exists to avoid.

Both are ``torch.autograd.Function``s over the axis's process group
(``parallel/mesh.py``); at an axis of size 1 they are the identity.

The layout (``TP_RULES``): a FeedForward's first linear is sharded on its
output rows and its second on its input columns. They are the JAX rule
``MOBILEVIT_TP_RULES`` (fc1 (I, O) on its column, fc2 on its row) for
the port's torch-layout (O, I) weights: ``net.0.weight`` on dim 0 (with
``net.0.bias`` if there is one), ``net.3.weight`` on dim 1.
``shard_tensor`` / ``gather_tensor`` move one tensor between its full and
its rank-local form; ``tp_dims`` names a model's sharded parameters.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

import torch

from picklebot_tpu_torch.parallel import mesh

# state-dict key -> the dim it is sharded on over 'model'
TP_RULES = (
    (re.compile(r"(.*\.)?transformer\.layers\.\d+\.1\.net\.0\.(weight|bias)"),
     0),
    (re.compile(r"(.*\.)?transformer\.layers\.\d+\.1\.net\.3\.weight"), 1),
)


def tp_dim(key: str) -> Optional[int]:
    """The dim a state-dict key is sharded on under TP, or None."""
    for rx, dim in TP_RULES:
        if rx.fullmatch(key):
            return dim
    return None


def tp_dims(model) -> Dict[str, int]:
    """{parameter name: sharded dim} of a model built with a
    ``model_axis`` of more than one rank (empty otherwise)."""
    out = {}
    for name, module in model.named_modules():
        for pname, dim in getattr(module, "tp_sharded", {}).items():
            out[f"{name}.{pname}" if name else pname] = dim
    return out


def shard_tensor(t: torch.Tensor, dim: int, rank: int,
                 n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/n of ``t`` along ``dim``."""
    if t.shape[dim] % n:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over "
                         f"{n} model-parallel ranks")
    return t.chunk(n, dim=dim)[rank].clone()


def gather_tensor(local: torch.Tensor, dim: int,
                  group: str = "model") -> torch.Tensor:
    """Every rank's shard of a tensor along ``dim``, concatenated in axis
    order: one all-gather over ``group``."""
    n = mesh.axis_size(group)
    if n == 1:
        return local
    stacked = mesh.all_gather(local.reshape(-1), group).view(
        (n,) + tuple(local.shape))
    return torch.cat(list(stacked.unbind(0)), dim=dim)


class _CopyIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum_(g.contiguous().clone(), ctx.axis), None


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return mesh.all_reduce_sum_(x.contiguous().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_copy_in(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """Identity forward, all-reduce over ``axis`` backward."""
    if mesh.axis_size(axis) == 1:
        return x
    return _CopyIn.apply(x, axis)


def tp_reduce_out(x: torch.Tensor, axis: str = "model") -> torch.Tensor:
    """All-reduce over ``axis`` forward, identity backward."""
    if mesh.axis_size(axis) == 1:
        return x
    return _ReduceOut.apply(x, axis)


# --------------------------------------------------------------------------
# the optimizer state in the JAX TP layout
# --------------------------------------------------------------------------

def _param_dims(model):
    """The TP dim (or None) of each trainable parameter, in the
    optimizer's order."""
    dims = tp_dims(model)
    return [dims.get(n) for n, p in model.named_parameters()
            if p.requires_grad]


def gather_optimizer_state(optimizer, model) -> dict:
    """The optimizer state with full leaves, as a snapshot holds it, in
    the layout of the JAX ``train_state_specs``: an f32 moment of a
    TP-sharded parameter gathered along the parameter's dim; an 8-bit one
    (each rank quantizes its own shard in its own 256-blocks, the JAX
    ``AdamW8bit.init(model_shards=)``) as the ranks' (blocks_local, 256)
    codes and (blocks_local, 1) scales stacked by model rank, (shards *
    blocks_local, ...). ``tp_dims`` and ``model_parallel`` record the
    layout. A collective over 'model' that every rank enters; host
    copies."""
    st = optimizer.state_dict()
    dims = _param_dims(model)
    n = mesh.axis_size("model")
    if n == 1 or not any(d is not None for d in dims):
        return st

    def full(s, dim, device):
        if dim is None:
            return s
        if isinstance(s, tuple):
            return tuple(gather_tensor(t.to(device), 0).cpu() for t in s)
        return gather_tensor(s.to(device), dim).cpu()

    device = optimizer.params[0].device
    shapes = []
    for shape, dim in zip(st["shapes"], dims):
        shape = list(shape)
        if dim is not None:
            shape[dim] *= n
        shapes.append(tuple(shape))
    return {"steps": st["steps"],
            "m": [full(s, d, device) for s, d in zip(st["m"], dims)],
            "v": [full(s, d, device) for s, d in zip(st["v"], dims)],
            "shapes": shapes, "tp_dims": dims, "model_parallel": n}


def local_optimizer_state(state: dict, optimizer, model) -> dict:
    """A snapshot's optimizer state (``gather_optimizer_state``'s layout
    at any degree, or a replicated one) -> this rank's, for
    ``optimizer.load_state_dict``. f32 moments are sliced exactly; 8-bit
    ones at the saved degree take this rank's blocks, and at another
    degree are decoded whole and quantized again on the new shard (and
    kept 8-bit or not by ``optimizer.quantizes``, as a fresh init
    decides)."""
    from picklebot_tpu_torch.train.optim import (dequantize_signed,
                                                 dequantize_unsigned,
                                                 quantize_signed,
                                                 quantize_unsigned)
    dims = _param_dims(model)
    n, r = mesh.axis_size("model"), mesh.axis_index("model")
    n_old = int(state.get("model_parallel", 1))
    old_dims = state.get("tp_dims") or [None] * len(state["shapes"])
    if n == 1 and n_old == 1:
        return state
    if len(old_dims) != len(dims):
        raise ValueError(f"optimizer state for {len(old_dims)} parameters "
                         f"does not fit these {len(dims)}")

    def whole(s, shape, old_dim, signed):
        """The full f32 moment."""
        if not isinstance(s, tuple):
            return s.float()
        deq = dequantize_signed if signed else dequantize_unsigned
        if old_dim is None:
            return deq(s[0], s[1], shape)
        local = list(shape)
        local[old_dim] //= n_old
        bl = s[0].shape[0] // n_old
        return torch.cat([deq(s[0][k * bl:(k + 1) * bl],
                              s[1][k * bl:(k + 1) * bl], tuple(local))
                          for k in range(n_old)], dim=old_dim)

    def local(s, shape, old_dim, dim, signed):
        if dim is None and old_dim is None:
            return s
        if isinstance(s, tuple) and old_dim is not None and n == n_old \
                and dim == old_dim:
            bl = s[0].shape[0] // n
            return tuple(t[r * bl:(r + 1) * bl].clone() for t in s)
        full_t = whole(s, shape, old_dim, signed)
        mine = full_t if dim is None else shard_tensor(full_t, dim, r, n)
        if isinstance(s, tuple) and optimizer.quantizes(mine.numel()):
            return (quantize_signed if signed else quantize_unsigned)(mine)
        return mine

    shapes = [tuple(s) for s in state["shapes"]]
    out_shapes = []
    for shape, dim in zip(shapes, dims):
        shape = list(shape)
        if dim is not None:
            shape[dim] //= n
        out_shapes.append(tuple(shape))
    return {"steps": state["steps"],
            "m": [local(s, sh, od, d, True) for s, sh, od, d in
                  zip(state["m"], shapes, old_dims, dims)],
            "v": [local(s, sh, od, d, False) for s, sh, od, d in
                  zip(state["v"], shapes, old_dims, dims)],
            "shapes": out_shapes}
