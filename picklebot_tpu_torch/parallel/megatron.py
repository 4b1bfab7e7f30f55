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

The layout of a sharded state dict (``SHARD_RULES``), one mechanism for
tensor and expert parallelism: each rule names a key, the mesh axis its
tensor is sharded over and the dim it is cut on. Under TP a
FeedForward's first linear is sharded on its output rows and its second on
its input columns over 'model': the JAX rule ``MOBILEVIT_TP_RULES`` (fc1
(I, O) on its column, fc2 on its row) for the port's torch-layout (O, I)
weights, ``net.0.weight`` on dim 0 (with ``net.0.bias`` if there is one),
``net.3.weight`` on dim 1. Under EP an MoE feed-forward's expert banks
``w1`` (h, d, E) and ``w2`` (d, h, E) are sharded on their expert dim, 2,
over 'expert' (the JAX ``MOBILEVIT_MOE_EP_RULES``, P('expert', None,
None) on the (E, ...) banks). A module built sharded names its own
parameters' (axis, dim) in ``sharded``; ``layout`` collects them for a
model. ``shard_tensor`` / ``gather_tensor`` move one tensor between its
full and its rank-local form. The optimizer state follows the same
layout (``gather_optimizer_state``, ``local_optimizer_state``).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

import torch

from picklebot_tpu_torch.parallel import mesh

# state-dict key -> (the mesh axis it is sharded over, the dim it is cut on)
SHARD_RULES = (
    (re.compile(r"(.*\.)?transformer\.layers\.\d+\.1\.net\.0\.(weight|bias)"),
     "model", 0),
    (re.compile(r"(.*\.)?transformer\.layers\.\d+\.1\.net\.3\.weight"),
     "model", 1),
    (re.compile(r"(.*\.)?transformer\.ffs\.\d+\.w[12]"), "expert", 2),
)
# the snapshot key of each sharded axis's degree
DEGREE_KEYS = {"model": "model_parallel", "expert": "expert_parallel"}


def shard_rule(key: str) -> Optional[Tuple[str, int]]:
    """(axis, dim) of a state-dict key that is sharded, or None."""
    for rx, axis, dim in SHARD_RULES:
        if rx.fullmatch(key):
            return axis, dim
    return None


def layout(model) -> Dict[str, Tuple[str, int]]:
    """{parameter name: (axis, dim)} of the parameters that a model built
    sharded (a ``model_axis`` or ``expert_axis`` of more than one rank)
    holds in part; empty otherwise."""
    out = {}
    for name, module in model.named_modules():
        for pname, axis_dim in getattr(module, "sharded", {}).items():
            out[f"{name}.{pname}" if name else pname] = axis_dim
    return out


def shard_tensor(t: torch.Tensor, dim: int, rank: int,
                 n: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous 1/n of ``t`` along ``dim``."""
    if t.shape[dim] % n:
        raise ValueError(f"a dim of {t.shape[dim]} does not split over "
                         f"{n} ranks")
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

def _param_layout(model):
    """The (axis, dim) of each trainable parameter sharded over an axis
    of more than one rank (else None), in the optimizer's order."""
    lay = layout(model)
    out = []
    for n, p in model.named_parameters():
        if not p.requires_grad:
            continue
        ad = lay.get(n)
        out.append(ad if ad is not None and mesh.axis_size(ad[0]) > 1
                   else None)
    return out


def gather_optimizer_state(optimizer, model) -> dict:
    """The optimizer state with full leaves, as a snapshot holds it, in
    the layout of the JAX ``train_state_specs``: an f32 moment of a
    sharded parameter gathered along the parameter's dim over its axis;
    an 8-bit one (each rank quantizes its own shard in its own 256-blocks,
    the JAX ``AdamW8bit.init(model_shards=)``) as the ranks'
    (blocks_local, 256) codes and (blocks_local, 1) scales stacked by
    rank of the axis, (shards * blocks_local, ...). ``tp_dims`` (the
    dims), ``shard_axes`` (the axes) and ``model_parallel`` /
    ``expert_parallel`` (the degrees) record the layout. A collective over
    each sharded axis that every rank enters; host copies."""
    st = optimizer.state_dict()
    lay = _param_layout(model)
    if not any(lay):
        return st

    def full(s, ad, device):
        if ad is None:
            return s
        axis, dim = ad
        if isinstance(s, tuple):
            return tuple(gather_tensor(t.to(device), 0, axis).cpu()
                         for t in s)
        return gather_tensor(s.to(device), dim, axis).cpu()

    device = optimizer.params[0].device
    shapes = []
    for shape, ad in zip(st["shapes"], lay):
        shape = list(shape)
        if ad is not None:
            shape[ad[1]] *= mesh.axis_size(ad[0])
        shapes.append(tuple(shape))
    out = {"steps": st["steps"],
           "m": [full(s, ad, device) for s, ad in zip(st["m"], lay)],
           "v": [full(s, ad, device) for s, ad in zip(st["v"], lay)],
           "shapes": shapes,
           "tp_dims": [None if ad is None else ad[1] for ad in lay],
           "shard_axes": [None if ad is None else ad[0] for ad in lay]}
    for axis in {ad[0] for ad in lay if ad is not None}:
        out[DEGREE_KEYS[axis]] = mesh.axis_size(axis)
    return out


def local_optimizer_state(state: dict, optimizer, model) -> dict:
    """A snapshot's optimizer state (``gather_optimizer_state``'s layout
    at any degree, or a replicated one) -> this rank's, for
    ``optimizer.load_state_dict``. f32 moments are sliced exactly; 8-bit
    ones at the saved axis and degree take this rank's blocks, and
    otherwise are decoded whole and quantized again on the new shard (and
    kept 8-bit or not by ``optimizer.quantizes``, as a fresh init
    decides)."""
    from picklebot_tpu_torch.train.optim import (dequantize_signed,
                                                 dequantize_unsigned,
                                                 quantize_signed,
                                                 quantize_unsigned)
    lay = _param_layout(model)
    old_dims = state.get("tp_dims") or [None] * len(state["shapes"])
    # a snapshot from before EP names no axes: its shards are over 'model'
    old_axes = state.get("shard_axes") or [
        None if d is None else "model" for d in old_dims]
    if len(old_dims) != len(lay):
        raise ValueError(f"optimizer state for {len(old_dims)} parameters "
                         f"does not fit these {len(lay)}")
    # (axis, dim, degree) of each saved moment, None where it is whole
    old = [None if d is None or int(state.get(DEGREE_KEYS[a], 1)) == 1
           else (a, d, int(state[DEGREE_KEYS[a]]))
           for a, d in zip(old_axes, old_dims)]
    if not any(lay) and not any(old):
        return state

    def whole(s, shape, o, signed):
        """The full f32 moment."""
        if not isinstance(s, tuple):
            return s.float()
        deq = dequantize_signed if signed else dequantize_unsigned
        if o is None:
            return deq(s[0], s[1], shape)
        _, dim, n_old = o
        local = list(shape)
        local[dim] //= n_old
        bl = s[0].shape[0] // n_old
        return torch.cat([deq(s[0][k * bl:(k + 1) * bl],
                              s[1][k * bl:(k + 1) * bl], tuple(local))
                          for k in range(n_old)], dim=dim)

    def local(s, shape, o, ad, signed):
        if ad is None and o is None:
            return s
        if ad is not None:
            n, r = mesh.axis_size(ad[0]), mesh.axis_index(ad[0])
        if isinstance(s, tuple) and o is not None and ad is not None \
                and o == (ad[0], ad[1], n):
            bl = s[0].shape[0] // n
            return tuple(t[r * bl:(r + 1) * bl].clone() for t in s)
        full_t = whole(s, shape, o, signed)
        mine = full_t if ad is None else shard_tensor(full_t, ad[1], r, n)
        if isinstance(s, tuple) and optimizer.quantizes(mine.numel()):
            return (quantize_signed if signed else quantize_unsigned)(mine)
        return mine

    shapes = [tuple(s) for s in state["shapes"]]
    out_shapes = []
    for shape, ad in zip(shapes, lay):
        shape = list(shape)
        if ad is not None:
            shape[ad[1]] //= mesh.axis_size(ad[0])
        out_shapes.append(tuple(shape))
    return {"steps": state["steps"],
            "m": [local(s, sh, o, ad, True) for s, sh, o, ad in
                  zip(state["m"], shapes, old, lay)],
            "v": [local(s, sh, o, ad, False) for s, sh, o, ad in
                  zip(state["v"], shapes, old, lay)],
            "shapes": out_shapes}
