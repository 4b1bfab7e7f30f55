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
launches per pass.

Under autograd (grad enabled and an input that requires grad)
``fused_bottleneck`` runs ``FusedBottleneckFn``: the same forward, and a
backward that recomputes the plain chain and differentiates it, as the JAX
package's ``custom_vjp`` does (``_fb_bwd``, an XLA recompute, not a
kernel). The backward launches no kernel. ``fused_pool`` and
``fused_main`` alone have no backward and raise under autograd.

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

import torch

from picklebot_tpu_torch.ops.activations import hardsigmoid, relu
from picklebot_tpu_torch.ops.conv import depthwise_conv, pointwise_conv

LAUNCHES = {"pool": 0, "main": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def out_shape(t: int, h: int, w: int, kernel_size: int, stride: int):
    """(T', H', W') of Bottleneck3D's depthwise conv: temporal kernel 1,
    but the stride and the padding k//2 act on T as well."""
    k, s, p = kernel_size, stride, kernel_size // 2
    return ((t + 2 * p - 1) // s + 1, (h + 2 * p - k) // s + 1,
            (w + 2 * p - k) // s + 1)


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


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _fn(name):
    if name not in _FNS:
        from picklebot_tpu_torch.utils.build import load_library
        lib = load_library("fused_bottleneck")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fb_pool.argtypes = [p, p, p, p] + [i] * 9 + [p]
        lib.fb_main.argtypes = [p, p, p, p, p, p] + [i] * 10 + [p]
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


def fused_pool(x, w1, wd, kernel_size: int, stride: int):
    """SE pass 1: f32 (B, E) per-sample sums of the depthwise output."""
    _no_graph("pool", x, w1, wd)
    if x.device.type == "cpu":
        return pool_reference(x, w1, wd, kernel_size, stride)
    _check(x, w1, wd, kernel_size)
    b, t, h, w, c = x.shape
    e = w1.shape[-1]
    pooled = torch.empty((b, e), device=x.device, dtype=torch.float32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("pool")(x.data_ptr(), w1.data_ptr(), wd.data_ptr(),
                          pooled.data_ptr(), _DTYPES[x.dtype], b, t, h, w,
                          c, e, kernel_size, stride, stream)
    _raise_on(err, "pool")
    LAUNCHES["pool"] += 1
    return pooled


def fused_main(x, w1, wd, w2, scale, kernel_size: int, stride: int):
    """Pass 2: expand -> depthwise -> x scale (f32 (B, E)) -> project."""
    _no_graph("main", x, w1, wd, w2, scale)
    if x.device.type == "cpu":
        return main_reference(x, w1, wd, w2, scale, kernel_size, stride)
    _check(x, w1, wd, kernel_size, w2=w2, scale=scale)
    b, t, h, w, c = x.shape
    e, co = w2.shape
    to, ho, wo = out_shape(t, h, w, kernel_size, stride)
    out = torch.empty((b, to, ho, wo, co), device=x.device, dtype=x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("main")(x.data_ptr(), w1.data_ptr(), wd.data_ptr(),
                          w2.data_ptr(), scale.data_ptr(), out.data_ptr(),
                          _DTYPES[x.dtype], b, t, h, w, c, e, co,
                          kernel_size, stride, stream)
    _raise_on(err, "main")
    LAUNCHES["main"] += 1
    return out


def _fused_forward(x, w1, wd, w2, se_w1, se_b1, se_w2, se_b2,
                   kernel_size, stride, use_se):
    if x.device.type == "cpu":
        return fused_bottleneck_reference(x, w1, wd, w2, se_w1, se_b1, se_w2,
                                          se_b2, kernel_size, stride, use_se)
    b, t, h, w, _ = x.shape
    if use_se:
        to, ho, wo = out_shape(t, h, w, kernel_size, stride)
        pooled = fused_pool(x, w1, wd, kernel_size, stride)
        scale = se_scale(pooled / float(to * ho * wo), se_w1, se_b1, se_w2,
                         se_b2, x.dtype)
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
