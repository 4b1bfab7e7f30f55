"""Stride-1, 'same'-padded dense 3-D conv on channels-last activations:
x (B, T, H, W, Ci), w (Kt, Kh, Kw, Ci, Co) -> (B, T, H, W, Co), with f32
accumulation.

Counterpart of ``picklebot_tpu/ops/pallas/folded_conv.py`` (``_kernel``,
reached through ``folded_conv_s1``), with that file's names. The TPU kernel
works on a W-folded layout (B, T, H, Wb, Ci) and takes ``wb``; with no
fold (``wb == W``) its function is the conv above, and that function is
what is ported. The lane folding, the per-tap f32 slabs and the K-packing
of adjacent W taps are TPU devices and are not carried over. On a CUDA
tensor the work runs in the hand-written kernel of ``csrc/folded_conv.cu``
(an implicit GEMM, bf16 on the tensor cores; see the note there for its
bound on the H100: the conv does 900 to 1,700 FLOPs per byte at
MobileViT-s's shapes, so operations bound it). On a CPU tensor the wrapper
computes ``folded_conv_reference``, the plain version (``F.conv3d`` on a
channels-first view, the counterpart of ``_ref_conv``); on a CUDA tensor it
launches the kernel or raises.

The bf16 kernel's launch follows ``_plan``: its block tile, and a split of
the taps into contiguous ranges (``tap_ranges``) where the grid would
leave the card's SMs short of blocks. A split conv sums f32 partials over
the ranges in order and rounds once; ``folded_conv_split_reference`` is
the plain version of that order.

Under autograd (grad enabled and x or w requiring grad) ``folded_conv_s1``
runs ``FoldedConvS1Fn``: forward the kernel; dx the same kernel on the
flipped taps with Ci and Co swapped, as ``_s1_bwd`` does (its flipped pads
are the pads themselves, since they are symmetric); dw the library's conv
weight gradient (``torch.nn.grad.conv3d_weight``). The JAX package computes
dw outside any Pallas kernel too (XLA's conv VJP), so a library call is its
counterpart: dw is not a hand-written kernel here.

``LAUNCHES`` counts kernel launches: ``fwd`` for the forward, ``dx`` for
the input gradient; in a torch profiler's trace each is a span of its
own (``SPANS``; ``utils/profiling.span``). The forward is also the custom op
``picklebot::folded_conv_fwd`` (``ops/library.py``), through which a
traced call goes, so that an exported program keeps it.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple
from typing import List

import torch
import torch.nn.functional as F

from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.utils.profiling import span

LAUNCHES = {"fwd": 0, "dx": 0}
SPANS = {"fwd": "picklebot.folded_conv.forward",
         "dx": "picklebot.folded_conv.dx"}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}

# the bf16 kernel's tiles (csrc/folded_conv.cu): 128 output positions by 64
# or 96 output channels; the H100's SM count
_TILE_M, _TILE_NS, _SMS = 128, (64, 96), 132

Plan = namedtuple("Plan", "tile_n splits blocks workspace")


def _plan(m: int, co: int, taps: int) -> Plan:
    """The bf16 kernel's launch for ``m`` = B*T*H*W output positions,
    ``co`` output channels and ``taps`` = Kt*Kh*Kw: the N tile (64 or 96)
    that computes the fewest columns past Co, the wider on a tie (it
    gathers each input tile fewer times); then, if that grid has fewer
    than two blocks per SM, the taps split into as many ranges as bring it
    to two per SM, at most one range per tap. ``workspace`` counts the f32
    partials the split writes (splits, M, Co), 0 unsplit."""
    tile_n = min(_TILE_NS, key=lambda n: (-(-co // n) * n, -n))
    blocks = -(-m // _TILE_M) * -(-co // tile_n)
    splits = 1 if blocks >= 2 * _SMS else min(taps, -(-2 * _SMS // blocks))
    return Plan(tile_n, splits, blocks * splits,
                splits * m * co if splits > 1 else 0)


def tap_ranges(taps: int, splits: int):
    """The kernel's split of the flat tap index (dt, dh, dw row-major) into
    ``splits`` contiguous ranges [lo, hi), in order."""
    return [(i * taps // splits, (i + 1) * taps // splits)
            for i in range(splits)]


def _same_pads(kernel):
    return tuple(((k - 1) // 2,) * 2 for k in kernel)


def folded_conv_s1_eligible(x_shape, w_shape, strides, pads) -> bool:
    """The JAX predicate: stride 1 on every axis, symmetric 'same' pads
    ((k-1)//2 on both sides, so dims are preserved) and at least 32 input
    and output channels; besides, every kernel size odd. (The JAX
    predicate admits an even size with those pads, for which its kernel
    keeps the input's dims while a conv with those pads loses one.)"""
    if tuple(strides) != (1, 1, 1):
        return False
    kernel = tuple(w_shape[:3])
    if any(k % 2 == 0 for k in kernel):
        return False
    if tuple(tuple(p) for p in pads) != _same_pads(kernel):
        return False
    return x_shape[-1] >= 32 and w_shape[-1] >= 32


def folded_conv_reference(x5, w, pads):
    """Plain version: ``F.conv3d`` on the channels-first view, in x's
    dtype, with the symmetric ``pads`` ((p, p) per axis)."""
    out = F.conv3d(x5.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                   padding=tuple(lo for lo, _ in pads))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def folded_conv_split_reference(x5, w, pads, splits: int):
    """Plain version of the split path: the conv over each range of taps
    (``tap_ranges``) in f32, the partials summed in range order, rounded
    once to x's dtype."""
    kt, kh, kw, ci, co = w.shape
    flat = w.float().reshape(kt * kh * kw, ci, co)
    total = None
    for lo, hi in tap_ranges(kt * kh * kw, splits):
        part_w = torch.zeros_like(flat)
        part_w[lo:hi] = flat[lo:hi]
        part = folded_conv_reference(x5.float(), part_w.reshape(w.shape),
                                     pads)
        total = part if total is None else total + part
    return total.to(x5.dtype)


def _fn():
    if "conv" not in _FNS:
        from picklebot_tpu_torch.utils.build import load_library
        lib = load_library("folded_conv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fc_conv_s1.argtypes = [p, p, p] + [i] * 15 + [p, p]
        lib.fc_conv_s1.restype = i
        _FNS["conv"] = lib.fc_conv_s1
    return _FNS["conv"]


def _check(x5, w, pads):
    if x5.dim() != 5 or w.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, Ci) and w (Kt, Kh, Kw, Ci, "
                         f"Co), got {tuple(x5.shape)} and {tuple(w.shape)}")
    if w.shape[3] != x5.shape[-1]:
        raise ValueError(f"w takes {w.shape[3]} input channels, x has "
                         f"{x5.shape[-1]}")
    if w.dtype != x5.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x5.dtype}")
    if w.device != x5.device:
        raise ValueError(f"tensors on {w.device} and {x5.device}")
    kernel = tuple(w.shape[:3])
    pads = tuple(tuple(int(v) for v in p) for p in pads)
    if any(k % 2 == 0 for k in kernel) or pads != _same_pads(kernel):
        raise ValueError(f"pads {pads} do not keep the dims under a {kernel} "
                         "kernel: the conv takes odd kernel sizes with "
                         "(k - 1) // 2 on both sides")
    return pads


def _conv(x5, w, pads, count: str):
    """The conv itself, no graph: the kernel on a CUDA tensor (counted
    once under ``count``, the split's sum pass included), the plain
    version on a CPU tensor; inside the profiler span of ``count``."""
    with span(SPANS[count]):
        pads = _check(x5, w, pads)
        if x5.device.type == "cpu":
            return folded_conv_reference(x5, w, pads)
        return _launch(x5, w, pads, count)


def _launch(x5, w, pads, count: str):
    """The kernel on checked CUDA tensors (``_check``'s pads)."""
    if x5.device.type != "cuda":
        raise ValueError(f"folded conv kernel: x is on {x5.device}; the "
                         "kernel runs on CUDA tensors only")
    if x5.dtype not in _DTYPES:
        raise TypeError(f"folded conv kernel: dtype {x5.dtype} (float32 or "
                        "bfloat16 only)")
    if not (x5.is_contiguous() and w.is_contiguous()):
        raise ValueError("folded conv kernel: inputs must be contiguous")
    b, t, h, wd, ci = x5.shape
    kt, kh, kw, _, co = w.shape
    out = torch.empty((b, t, h, wd, co), device=x5.device, dtype=x5.dtype)
    tile_n, splits, part = 0, 1, None        # f32: one FMA tile, no split
    if x5.dtype == torch.bfloat16:
        plan = _plan(b * t * h * wd, co, kt * kh * kw)
        tile_n, splits = plan.tile_n, plan.splits
        if plan.workspace:
            # freed on return: the caching allocator hands it out again only
            # to work queued behind these kernels on the same stream
            part = torch.empty(plan.workspace, device=x5.device,
                               dtype=torch.float32)
    with torch.cuda.device(x5.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(x5.data_ptr(), w.data_ptr(), out.data_ptr(),
                    _DTYPES[x5.dtype], b, t, h, wd, ci, co, kt, kh, kw,
                    pads[0][0], pads[1][0], pads[2][0], tile_n, splits,
                    None if part is None else part.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"folded conv {count} kernel: launch failed with "
                           f"CUDA error {err}")
    LAUNCHES[count] += 1
    return out


def _weight_grad(x5, w_shape, g, pads):
    """dw by the library's conv weight gradient, (Kt, Kh, Kw, Ci, Co)."""
    kt, kh, kw, ci, co = w_shape
    dw = torch.nn.grad.conv3d_weight(x5.permute(0, 4, 1, 2, 3),
                                     (co, ci, kt, kh, kw),
                                     g.permute(0, 4, 1, 2, 3),
                                     padding=tuple(lo for lo, _ in pads))
    return dw.permute(2, 3, 4, 1, 0)


class FoldedConvS1Fn(torch.autograd.Function):
    """``folded_conv_s1`` under autograd: forward and dx on the kernel (on
    the card), dw from the library."""

    @staticmethod
    def forward(ctx, x5, w, pads):
        ctx.save_for_backward(x5, w)
        ctx.pads = pads
        return _conv(x5, w, pads, "fwd")

    @staticmethod
    def backward(ctx, g):
        x5, w = ctx.saved_tensors
        pads = ctx.pads
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # the transpose of a same-padded stride-1 conv: the same conv
            # with flipped taps and Ci <-> Co swapped weights (the flipped
            # pads (k-1-hi, k-1-lo) of symmetric pads are the pads)
            w_flip = w.flip(0, 1, 2).transpose(-1, -2).contiguous()
            dx = _conv(g, w_flip, pads, "dx")
        if ctx.needs_input_grad[1]:
            dw = _weight_grad(x5, w.shape, g, pads).to(w.dtype)
        return dx, dw, None


@torch.library.custom_op(f"{library.NAMESPACE}::folded_conv_fwd",
                         mutates_args=(), device_types="cuda")
def _conv_op(x5: torch.Tensor, w: torch.Tensor,
             pads: List[int]) -> torch.Tensor:
    return _launch(x5, w, _check(x5, w, [(p, p) for p in pads]), "fwd")


@_conv_op.register_kernel("cpu")
def _conv_op_cpu(x5, w, pads):
    return folded_conv_reference(x5, w, _check(x5, w,
                                               [(p, p) for p in pads]))


@_conv_op.register_fake
def _conv_op_fake(x5, w, pads):
    return x5.new_empty((*x5.shape[:-1], w.shape[-1]))


def folded_conv_s1(x5, w, pads):
    """Stride-1 dense conv, (B, T, H, W, Ci) -> (B, T, H, W, Co), x5
    contiguous, w (Kt, Kh, Kw, Ci, Co) in x5's dtype (bf16 or f32), ``pads``
    the symmetric same-conv pads ((lo, hi) per axis; use
    ``folded_conv_s1_eligible`` first). The kernel on a CUDA tensor, the
    plain version on a CPU tensor; under autograd through
    ``FoldedConvS1Fn``."""
    pads = tuple(tuple(p) for p in pads)
    if torch.is_grad_enabled() and (x5.requires_grad or w.requires_grad):
        return FoldedConvS1Fn.apply(x5, w, pads)
    if library.use_ops():
        return _conv_op(x5, w, [lo for lo, _ in pads])
    return _conv(x5, w, pads, "fwd")
