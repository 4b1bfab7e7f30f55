"""Fused inverted bottleneck: expand 1x1 -> (1,k,k) depthwise -> SE scale ->
project 1x1, without writing the expanded tensor to device memory.

Counterpart of ``picklebot_tpu/ops/pallas/fused_bottleneck.py``. On a CUDA
tensor the work runs in the two hand-written kernels of
``csrc/fused_bottleneck.cu`` (see the note there for the TPU kernels they
replace, their bound on the H100 and the E-chunk design):

  pool pass  (``fused_pool``): per-sample sum over (T', H', W') of the
             depthwise output, f32 (B, E). Runs only for SE blocks.
  SE MLP     (``se_scale``): on (B, E) in torch, as JAX runs it outside
             its kernel.
  main pass  (``fused_main``): expand, depthwise, x scale, project.

On a CPU tensor each wrapper computes its plain PyTorch version instead; on
a CUDA tensor it launches its kernel or raises. ``LAUNCHES`` counts kernel
launches per pass (a split's sum kernel is part of its pass). The two
passes are also the custom ops ``picklebot::fused_pool`` and
``picklebot::fused_main`` (``ops/library.py``), through which a traced
call (``torch.export``) goes, so that an exported program keeps them.

Each launch follows a plan (``_pool_plan``, ``_main_plan``): the output
tile, the 32-channel E-chunk, and where the grid would leave the card's
SMs short of blocks a split: the pool pass cuts each sample's (valid
output frame, tile) items into contiguous ranges, the bf16 main pass its
E-chunks; each range writes f32 partials that a second kernel adds in
order. ``pool_split_reference`` and ``main_split_reference`` are the
plain versions of that order and of the bf16 kernels' numerics.

Under autograd (grad enabled and an input that requires grad)
``fused_bottleneck`` runs ``FusedBottleneckFn``: the same forward, and a
backward that recomputes the plain chain and differentiates it, as the JAX
package's ``custom_vjp`` does (``_fb_bwd``, an XLA recompute, not a
kernel). The backward launches no kernel. ``fused_pool`` and
``fused_main`` alone have no backward and raise under autograd. In a
torch profiler's trace the forward (both passes and the SE MLP) and the
backward (the recompute and its gradient) are the spans
``picklebot.fused_bottleneck.forward`` and ``.backward``
(``utils/profiling.span``).

Weight layouts are the JAX package's, as matrices: w1 (C, E), wd (k, k, E),
w2 (E, Co), se_w1 (E, E/4), se_b1 (E/4,), se_w2 (E/4, E), se_b2 (E,).
Activations are channels-last: x (B, T, H, W, C) -> (B, T', H', W', Co).
Numerics follow the Pallas kernel: expand accumulates in f32, the expanded
values stay f32 through the depthwise and the scale, and are rounded to
x's dtype only as the projection's operand, which accumulates in f32. The
plain version rounds its intermediates to x's dtype, as the module chain
(and ``_unfused_reference``) does.
"""

from __future__ import annotations

import ctypes
import functools
from collections import namedtuple

import torch

from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.ops.activations import hardsigmoid, relu
from picklebot_tpu_torch.ops.conv import depthwise_conv, pointwise_conv
from picklebot_tpu_torch.utils.profiling import span

LAUNCHES = {"pool": 0, "main": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def out_shape(t: int, h: int, w: int, kernel_size: int, stride: int):
    """(T', H', W') of Bottleneck3D's depthwise conv: temporal kernel 1,
    but the stride and the padding k//2 act on T as well."""
    k, s, p = kernel_size, stride, kernel_size // 2
    return ((t + 2 * p - 1) // s + 1, (h + 2 * p - k) // s + 1,
            (w + 2 * p - k) // s + 1)


def valid_frames(t: int, kernel_size: int, stride: int):
    """(first, count) of the output frames that read an input frame
    (t'*s - k//2 in [0, T)); the others are zero frames."""
    p = kernel_size // 2
    to = out_shape(t, 1, 1, kernel_size, stride)[0]
    first = -(-p // stride)
    last = min(to - 1, (t - 1 + p) // stride)
    return first, max(0, last - first + 1)


# --------------------------------------------------------------------------
# plans (csrc/fused_bottleneck.cu checks them and refuses one that does not
# fit)
# --------------------------------------------------------------------------

_SMS = 132                       # the H100's SMs
_SMEM_BLOCK = 227 * 1024         # shared memory one block may take
_SMEM_HALF = 113 * 1024          # ... and two blocks on one SM
_CHUNK = 32                      # expanded channels per chunk
_MAX_ACC_TILES = 80              # bf16 main: m16n8 output tiles (8 warps)
_MAX_OUT_TILE = 256 * 40         # f32 main: output accumulators
_TILE_PIX = (128, 96, 64, 48, 32, 16, 8, 4, 2, 1)
_GRID_MAX = 2 ** 31 - 1

Plan = namedtuple("Plan", "th tw chunk splits blocks smem workspace")


def _r16(n: int) -> int:
    return -(-n // 16) * 16


def _even_tile(ho: int, wo: int, pix: int):
    """An output tile of at most ``pix`` pixels, at most 16 wide, its
    rows and columns spread evenly over the frame."""
    tw = min(wo, 16, pix)
    tw = -(-wo // -(-wo // tw))
    th = min(ho, max(1, pix // tw))
    return -(-ho // -(-ho // th)), tw


def _smem_bf16(th, tw, c, co, k, s, main):
    """Bytes of the bf16 kernels' shared memory (``make_layout_bf16``)."""
    q = _r16(((th - 1) * s + k) * ((tw - 1) * s + k))
    xs = q * (_r16(c) + 8) * 2
    w1 = _r16(c) * (_CHUNK + 8) * 2
    wd = k * k * _CHUNK * 2
    es = q * (_CHUNK + 8) * 4
    if main:
        w2 = _CHUNK * (_r16(co) + 8) * 2
        return xs + 2 * (w1 + wd + w2) + es + _r16(th * tw) * (_CHUNK + 8) * 2
    return 2 * xs + w1 + wd + es + 8 * _CHUNK * 4


def _smem_f32(th, tw, c, co, k, s, main):
    """Bytes of the f32 kernels' shared memory (``make_layout``)."""
    q = ((th - 1) * s + k) * ((tw - 1) * s + k)
    n = _r16(q * c * 4) + _r16(c * _CHUNK * 4) + _r16(k * k * _CHUNK * 4)
    n += _r16(q * _CHUNK * 4)
    if main:
        return n + _r16(_CHUNK * co * 4) + _r16(th * tw * _CHUNK * 4)
    return n + _r16(8 * _CHUNK * 4)


def _tile_bf16(ho, wo, c, co, k, s, main):
    """The largest tile of ``_TILE_PIX`` whose shared memory lets two
    blocks share an SM, else the largest that fits one, whose (main pass)
    output tile fits the accumulators; None if none fits."""
    fits_one = None
    for pix in _TILE_PIX:
        th, tw = _even_tile(ho, wo, pix)
        if main and (_r16(th * tw) // 16) * (_r16(co) // 8) > _MAX_ACC_TILES:
            continue
        smem = _smem_bf16(th, tw, c, co, k, s, main)
        if smem <= _SMEM_HALF:
            return th, tw, smem
        if smem <= _SMEM_BLOCK and fits_one is None:
            fits_one = th, tw, smem
    return fits_one


def _tile_f32(ho, wo, c, co, k, s, main):
    """The f32 kernels' tile: 16 wide and 64 pixels where they fit, cut
    row by row, then column by column, until the shared memory and (main
    pass) the accumulators fit; None if none does."""
    tw = min(wo, 16)
    th = max(1, min(64 // tw, ho))
    while True:
        smem = _smem_f32(th, tw, c, co, k, s, main)
        if smem <= _SMEM_BLOCK and (not main or th * tw * co <= _MAX_OUT_TILE):
            return th, tw, smem
        if th > 1:
            th -= 1
        elif tw > 1:
            tw -= 1
        else:
            return None


def _tiles(shape, kernel_size, stride, co, dtype, main):
    b, t, h, w, c = shape
    _, ho, wo = out_shape(t, h, w, kernel_size, stride)
    if ho < 1 or wo < 1:
        raise ValueError(f"fused bottleneck: no output pixel for x "
                         f"{tuple(shape)} at k {kernel_size}, s {stride}")
    pick = _tile_bf16 if dtype == torch.bfloat16 else _tile_f32
    tile = pick(ho, wo, c, co, kernel_size, stride, main)
    if tile is None:
        raise ValueError(f"fused bottleneck: no tile fits shared memory for "
                         f"x {tuple(shape)}, Co {co}, k {kernel_size}")
    th, tw, smem = tile
    return th, tw, smem, -(-ho // th) * -(-wo // tw)


def _short_grid_splits(blocks: int, most: int) -> int:
    """1 if ``blocks`` gives every SM two blocks, else as many ranges (at
    most ``most``) as bring the grid to two blocks per SM."""
    if blocks >= 2 * _SMS:
        return 1
    return max(1, min(most, -(-2 * _SMS // blocks)))


@functools.lru_cache(maxsize=1024)
def _pool_plan(shape, kernel_size: int, stride: int, e: int,
               dtype) -> Plan:
    """The pool pass's launch for x of ``shape`` (B, T, H, W, C): the
    tile, then one block per (sample, E-chunk), each sample's (valid
    output frame, tile) items split into as many contiguous ranges as give
    the grid two blocks per SM (at most one range per item), in bf16 and
    f32 alike. ``workspace`` counts the f32 partials (B, splits, E), 0
    unsplit."""
    b, t = shape[0], shape[1]
    th, tw, smem, tiles = _tiles(shape, kernel_size, stride, 1, dtype, False)
    items = valid_frames(t, kernel_size, stride)[1] * tiles
    base = b * -(-e // _CHUNK)
    splits = _short_grid_splits(base, items)
    if base * splits > _GRID_MAX:
        raise ValueError(f"fused bottleneck pool: {base * splits} blocks")
    return Plan(th, tw, _CHUNK, splits, base * splits, smem,
                b * splits * e if splits > 1 else 0)


@functools.lru_cache(maxsize=1024)
def _main_plan(shape, kernel_size: int, stride: int, e: int, co: int,
               dtype) -> Plan:
    """The main pass's launch: the tile, then one block per output tile;
    in bf16, where that grid is short of two blocks per SM, the E-chunks
    split into as many ordered ranges as bring it there (at most one
    chunk per range). ``workspace`` counts the f32 partials (splits,
    B*T'*H'*W', Co), 0 unsplit."""
    b, t, h, w, _ = shape
    th, tw, smem, tiles = _tiles(shape, kernel_size, stride, co, dtype, True)
    to, ho, wo = out_shape(t, h, w, kernel_size, stride)
    base = b * to * tiles
    splits = 1
    if dtype == torch.bfloat16:
        splits = _short_grid_splits(base, -(-e // _CHUNK))
    if base * splits > _GRID_MAX:
        raise ValueError(f"fused bottleneck main: {base * splits} blocks")
    return Plan(th, tw, _CHUNK, splits, base * splits, smem,
                splits * b * to * ho * wo * co if splits > 1 else 0)


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def _expand_depthwise(x, w1, wd, stride):
    return depthwise_conv(pointwise_conv(x, w1), wd, stride)


def pool_reference(x, w1, wd, kernel_size: int, stride: int):
    """Plain pool pass: f32 (B, E) sums of the depthwise output."""
    assert wd.shape[0] == kernel_size
    return _expand_depthwise(x, w1, wd, stride).float().sum(dim=(1, 2, 3))


def main_reference(x, w1, wd, w2, scale, kernel_size: int, stride: int):
    """Plain main pass: expand -> depthwise -> x scale (B, E) -> project."""
    assert wd.shape[0] == kernel_size
    d = _expand_depthwise(x, w1, wd, stride)
    d = d * scale.to(d.dtype)[:, None, None, None, :]
    return pointwise_conv(d, w2)


def se_scale(mean, se_w1, se_b1, se_w2, se_b2, dtype):
    """SE MLP on the pooled (B, E) mean, in ``dtype``: relu, then
    hardsigmoid. Returns the f32 channel scale."""
    s = relu(mean.to(dtype) @ se_w1.to(dtype) + se_b1.to(dtype))
    s = hardsigmoid(s @ se_w2.to(dtype) + se_b2.to(dtype))
    return s.float()


def fused_bottleneck_reference(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                               kernel_size: int, stride: int, use_se: bool):
    """Plain version of the whole chain, in x's dtype (mirrors
    ``_unfused_reference``)."""
    assert wd.shape[0] == kernel_size
    d = _expand_depthwise(x, w1, wd, stride)
    if use_se:
        mean = d.float().mean(dim=(1, 2, 3))
        d = d * se_scale(mean, se_w1, se_b1, se_w2, se_b2,
                         x.dtype).to(d.dtype)[:, None, None, None, :]
    return pointwise_conv(d, w2)


def pool_split_reference(x, w1, wd, kernel_size: int, stride: int,
                         plan: Plan = None):
    """Plain version of the pool kernels' order: the depthwise output in
    f32 (expand and stencil from x's values, nothing rounded), summed per
    range of each sample's (valid output frame, tile) items as ``plan``
    (default ``_pool_plan``) splits them, the ranges' f32 sums then added
    in range order. f32 (B, E)."""
    assert wd.shape[0] == kernel_size
    b, t, h, w, _ = x.shape
    e = w1.shape[-1]
    plan = plan or _pool_plan(tuple(x.shape), kernel_size, stride, e,
                              x.dtype)
    d = _expand_depthwise(x.float(), w1.float(), wd.float(), stride)
    first, n_valid = valid_frames(t, kernel_size, stride)
    d = d[:, first:first + n_valid]                  # (B, V, H', W', E)
    _, _, ho, wo, _ = d.shape
    n_tw = -(-wo // plan.tw)
    tiles = -(-ho // plan.th) * n_tw
    tile = ((torch.arange(ho) // plan.th)[:, None] * n_tw
            + (torch.arange(wo) // plan.tw)[None, :])
    item = torch.arange(n_valid)[:, None, None] * tiles + tile
    items = n_valid * tiles
    bounds = torch.tensor([items * i // plan.splits
                           for i in range(1, plan.splits)], dtype=torch.long)
    split = torch.bucketize(item, bounds, right=True).to(d.device)
    total = None
    for i in range(plan.splits):
        part = (d * (split == i)[None, ..., None]).sum(dim=(1, 2, 3))
        total = part if total is None else total + part
    return total


def main_split_reference(x, w1, wd, w2, scale, kernel_size: int,
                         stride: int, splits: int = 1):
    """Plain version of the bf16 main kernel's numerics and order: per
    range of E-chunks (``splits`` ordered ranges of the 32-channel chunks)
    expand, stencil and scale in f32, round to x's dtype as the
    projection's operand, project with f32 accumulation; the ranges' f32
    partials added in order and rounded once to x's dtype."""
    assert wd.shape[0] == kernel_size
    e = w1.shape[-1]
    chunks = -(-e // _CHUNK)
    xf, w1f, wdf, w2f = (t.float() for t in (x, w1, wd, w2))
    total = None
    for i in range(splits):
        lo = i * chunks // splits * _CHUNK
        hi = min(e, (i + 1) * chunks // splits * _CHUNK)
        d = _expand_depthwise(xf, w1f[:, lo:hi], wdf[..., lo:hi], stride)
        d = (d * scale[:, None, None, None, lo:hi]).to(x.dtype).float()
        part = pointwise_conv(d, w2f[lo:hi])
        total = part if total is None else total + part
    return total.to(x.dtype)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _fn(name):
    if name not in _FNS:
        from picklebot_tpu_torch.utils.build import load_library
        lib = load_library("fused_bottleneck")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fb_pool.argtypes = [p, p, p, p] + [i] * 12 + [p, p]
        lib.fb_main.argtypes = [p, p, p, p, p, p] + [i] * 13 + [p, p]
        lib.fb_pool.restype = lib.fb_main.restype = i
        _FNS.update(pool=lib.fb_pool, main=lib.fb_main)
    return _FNS[name]


def _check(x, w1, wd, kernel_size, w2=None, scale=None):
    if x.device.type != "cuda":
        raise ValueError(f"fused bottleneck kernel: x is on {x.device}; "
                         "the kernel runs on CUDA tensors only")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused bottleneck kernel: dtype {x.dtype} "
                        "(float32 or bfloat16 only)")
    if x.dim() != 5:
        raise ValueError(f"x must be (B, T, H, W, C), got {tuple(x.shape)}")
    c, e, k = x.shape[-1], w1.shape[-1], kernel_size
    want = {"w1": (w1, (c, e)), "wd": (wd, (k, k, e))}
    if w2 is not None:
        want["w2"] = (w2, (e, w2.shape[-1]))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    tensors = [x, w1, wd] + ([w2] if w2 is not None else [])
    if scale is not None:
        if scale.dtype != torch.float32 or tuple(scale.shape) != (
                x.shape[0], e):
            raise ValueError(f"scale must be float32 {(x.shape[0], e)}, got "
                             f"{scale.dtype} {tuple(scale.shape)}")
        tensors.append(scale)
    for t in tensors:
        if t.device != x.device:
            raise ValueError(f"tensors on {t.device} and {x.device}")
        if not t.is_contiguous():
            raise ValueError("fused bottleneck kernel: inputs must be "
                             "contiguous")


def _workspace(plan: Plan, device):
    """The f32 partials of a split launch, None unsplit."""
    if not plan.workspace:
        return None
    return torch.empty(plan.workspace, device=device, dtype=torch.float32)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"fused bottleneck {what} kernel: launch failed "
                           f"with CUDA error {err}")


def _needs_graph(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def _no_graph(what, *ts):
    if _needs_graph(*ts):
        raise NotImplementedError(
            f"fused bottleneck {what} pass: no backward of its own; "
            "differentiate fused_bottleneck (FusedBottleneckFn) instead")


def _launch_pool(x, w1, wd, kernel_size: int, stride: int):
    """The pool kernel on CUDA tensors (the op's CUDA implementation)."""
    _check(x, w1, wd, kernel_size)
    b, t, h, w, c = x.shape
    e = w1.shape[-1]
    plan = _pool_plan(tuple(x.shape), kernel_size, stride, e, x.dtype)
    pooled = torch.empty((b, e), device=x.device, dtype=torch.float32)
    # freed on return: the caching allocator hands it out again only to
    # work queued behind these kernels on the same stream
    part = _workspace(plan, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("pool")(x.data_ptr(), w1.data_ptr(), wd.data_ptr(),
                          pooled.data_ptr(), _DTYPES[x.dtype], b, t, h, w,
                          c, e, kernel_size, stride, plan.th, plan.tw,
                          plan.splits, _ptr(part), stream)
    _raise_on(err, "pool")
    LAUNCHES["pool"] += 1
    return pooled


def _launch_main(x, w1, wd, w2, scale, kernel_size: int, stride: int):
    """The main kernel on CUDA tensors (the op's CUDA implementation)."""
    _check(x, w1, wd, kernel_size, w2=w2, scale=scale)
    b, t, h, w, c = x.shape
    e, co = w2.shape
    to, ho, wo = out_shape(t, h, w, kernel_size, stride)
    plan = _main_plan(tuple(x.shape), kernel_size, stride, e, co, x.dtype)
    out = torch.empty((b, to, ho, wo, co), device=x.device, dtype=x.dtype)
    part = _workspace(plan, x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("main")(x.data_ptr(), w1.data_ptr(), wd.data_ptr(),
                          w2.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          _DTYPES[x.dtype], b, t, h, w, c, e, co,
                          kernel_size, stride, plan.th, plan.tw,
                          plan.splits, _ptr(part), stream)
    _raise_on(err, "main")
    LAUNCHES["main"] += 1
    return out


@torch.library.custom_op(f"{library.NAMESPACE}::fused_pool", mutates_args=(),
                         device_types="cuda")
def _pool_op(x: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
             kernel_size: int, stride: int) -> torch.Tensor:
    return _launch_pool(x, w1, wd, kernel_size, stride)


@_pool_op.register_kernel("cpu")
def _pool_op_cpu(x, w1, wd, kernel_size, stride):
    return pool_reference(x, w1, wd, kernel_size, stride)


@_pool_op.register_fake
def _pool_op_fake(x, w1, wd, kernel_size, stride):
    return x.new_empty((x.shape[0], w1.shape[-1]), dtype=torch.float32)


@torch.library.custom_op(f"{library.NAMESPACE}::fused_main", mutates_args=(),
                         device_types="cuda")
def _main_op(x: torch.Tensor, w1: torch.Tensor, wd: torch.Tensor,
             w2: torch.Tensor, scale: torch.Tensor, kernel_size: int,
             stride: int) -> torch.Tensor:
    return _launch_main(x, w1, wd, w2, scale, kernel_size, stride)


@_main_op.register_kernel("cpu")
def _main_op_cpu(x, w1, wd, w2, scale, kernel_size, stride):
    return main_reference(x, w1, wd, w2, scale, kernel_size, stride)


@_main_op.register_fake
def _main_op_fake(x, w1, wd, w2, scale, kernel_size, stride):
    b, t, h, w, _ = x.shape
    return x.new_empty((b, *out_shape(t, h, w, kernel_size, stride),
                        w2.shape[-1]))


def fused_pool(x, w1, wd, kernel_size: int, stride: int):
    """SE pass 1: f32 (B, E) per-sample sums of the depthwise output."""
    _no_graph("pool", x, w1, wd)
    if library.use_ops():
        return _pool_op(x, w1, wd, kernel_size, stride)
    if x.device.type == "cpu":
        return pool_reference(x, w1, wd, kernel_size, stride)
    return _launch_pool(x, w1, wd, kernel_size, stride)


def fused_main(x, w1, wd, w2, scale, kernel_size: int, stride: int):
    """Pass 2: expand -> depthwise -> x scale (f32 (B, E)) -> project."""
    _no_graph("main", x, w1, wd, w2, scale)
    if library.use_ops():
        return _main_op(x, w1, wd, w2, scale, kernel_size, stride)
    if x.device.type == "cpu":
        return main_reference(x, w1, wd, w2, scale, kernel_size, stride)
    return _launch_main(x, w1, wd, w2, scale, kernel_size, stride)


def _fused_forward(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                   kernel_size, stride, use_se):
    with span("picklebot.fused_bottleneck.forward"):
        if x.device.type == "cpu" and not library.use_ops():
            return fused_bottleneck_reference(x, w1, wd, w2, se_w1, se_b1,
                                              se_w2, se_b2, kernel_size,
                                              stride, use_se)
        b, t, h, w, _ = x.shape
        if use_se:
            to, ho, wo = out_shape(t, h, w, kernel_size, stride)
            pooled = fused_pool(x, w1, wd, kernel_size, stride)
            scale = se_scale(pooled / float(to * ho * wo), se_w1, se_b1,
                             se_w2, se_b2, x.dtype)
        else:
            scale = torch.ones((b, w1.shape[-1]), device=x.device,
                               dtype=torch.float32)
        return fused_main(x, w1, wd, w2, scale, kernel_size, stride)


class FusedBottleneckFn(torch.autograd.Function):
    """The fused chain under autograd: the forward of ``fused_bottleneck``
    (the kernels on the card), the backward a recompute through
    ``fused_bottleneck_reference`` differentiated by autograd. The weights
    are the outputs of ``Bottleneck3D.kernel_weights``, so their gradients
    flow on through its transposes and casts to the f32 parameters."""

    @staticmethod
    def forward(ctx, x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                kernel_size, stride, use_se):
        ctx.save_for_backward(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2)
        ctx.static = (kernel_size, stride, use_se)
        return _fused_forward(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                              kernel_size, stride, use_se)

    @staticmethod
    def backward(ctx, g):
        with span("picklebot.fused_bottleneck.backward"):
            inputs = [None if t is None else
                      t.detach().requires_grad_(need)
                      for t, need in zip(ctx.saved_tensors,
                                         ctx.needs_input_grad)]
            with torch.enable_grad():
                out = fused_bottleneck_reference(*inputs, *ctx.static)
            wrt = [t for t in inputs if t is not None and t.requires_grad]
            grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True))
            return (*(next(grads) if t is not None and t.requires_grad
                      else None for t in inputs), None, None, None)


def fused_bottleneck(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                     kernel_size: int, stride: int, use_se: bool):
    """The whole chain: the kernels on a CUDA tensor (pool pass, SE MLP in
    torch, main pass), the plain version on a CPU tensor; under autograd
    through ``FusedBottleneckFn``. The SE arguments are ignored (and may
    be None) when ``use_se`` is false."""
    args = (x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2)
    if _needs_graph(*args):
        return FusedBottleneckFn.apply(*args, kernel_size, stride, use_se)
    return _fused_forward(*args, kernel_size, stride, use_se)
