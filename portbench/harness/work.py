"""Work counts of the cells, kept with the benchmark: FLOPs per clip of
the reference model, the published peaks of the card, and the least
time of each hand-written function per call.

Everything is counted on the plain reference (``portbench/reference``)
on the ``meta`` device: shapes only, no arithmetic, nothing of the
program.
"""

from __future__ import annotations

import math

import torch

HBM_BYTES_PER_S = 3.35e12                        # H100 SXM
PEAK_FLOPS = {2: 989e12, 4: 67e12}               # bf16 dense; f32 no TF32
PEAK_BF16_FLOPS = PEAK_FLOPS[2]


def least_ms(nbytes, flops, elem=2):
    """Least time (ms) on an H100: max(bytes / 3.35 TB/s, FLOPs / peak)."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[elem]) * 1e3


# ---------------------------------------------------------------- FLOPs

def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """FLOPs of ``aten.convolution_backward`` with the groups counted: the
    input gradient and the weight gradient each cost what the forward
    conv costs, 2 per weight element, sample and output position (input
    position for a transposed conv). The counter's own formula counts a
    depthwise conv's backward as a dense one's, ``groups`` times too
    many."""
    positions = math.prod((x_shape if transposed else grad_out_shape)[2:])
    forward = 2 * math.prod(w_shape) * x_shape[0] * positions
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def flop_counter():
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def flops_per_clip(model, clip_shape, batch, train):
    """FLOPs per clip of one forward (and, with ``train``, its backward)
    of ``model`` (a reference model, moved to ``meta`` here) on a batch
    of ``batch`` clips (T, H, W)."""
    model = model.to("meta")
    model.train(train)
    x = torch.empty((batch, 3) + tuple(clip_shape), device="meta")
    gen = None
    counter = flop_counter()
    with counter:
        if train:
            out = model(x, gen)
            out.float().sum().backward()
        else:
            with torch.no_grad():
                model(x, gen)
    return counter.get_total_flops() / batch


# ------------------------------------------------ the functions' work

def fused_bottleneck_work(shape, k, s, e, co, use_se, elem=2):
    """(bytes, FLOPs) of one fused bottleneck call, counted once: the
    input frames the output reads, the weights and the whole output, each
    moved once (no expanded tensor); expand, the depthwise stencil, the
    SE scale and the projection, each once, over the output frames that
    read an input frame (the others are zero: the expand has no bias).
    ``shape`` is the input's (B, T, H, W, C); the depthwise kernel is
    (1, k, k) with stride ``s`` and padding k // 2 on T, H and W."""
    b, t, h, w, c = shape
    p = k // 2
    to, ho, wo = ((t + 2 * p - 1) // s + 1, (h + 2 * p - k) // s + 1,
                  (w + 2 * p - k) // s + 1)
    frames = b * sum(1 for i in range(to) if 0 <= i * s - p < t)
    nbytes = (frames * h * w * c + c * e + k * k * e + e * co
              + b * to * ho * wo * co) * elem
    if use_se:
        nbytes += (2 * e * (e // 4) + e + e // 4) * elem
    px = frames * ho * wo
    flops = (2 * frames * h * w * c * e + 2 * px * k * k * e
             + 2 * px * e * co + (px * e if use_se else 0))
    return nbytes, flops


def flash_work(s, h, n, d, elem=2, with_lse=False):
    """(bytes, FLOPs) of one flash forward: Q, K, V read and O (and the
    f32 lse) written once; QK^T and PV, 4*N^2*D per (sequence, head)."""
    nbytes = 4 * s * h * n * d * elem + (s * h * n * 4 if with_lse else 0)
    return nbytes, 4 * s * h * n * n * d


def flash_backward_work(s, h, n, d, elem=2):
    """(bytes, FLOPs) of the flash backward as one function: q, k, v, dO
    read and dq, dk, dv written, with the f32 lse and D; S, dP, dV, dQ
    and dK once each, 10*N^2*D per (sequence, head)."""
    nbytes = 7 * s * h * n * d * elem + 2 * s * h * n * 4
    return nbytes, 10 * s * h * n * n * d


def conv_work(shape, co, kernel, elem=2):
    """(bytes, FLOPs) of the stride-1 'same' dense conv: x and w read and
    the output written once; 2*Ci*Co FLOPs per output position and tap
    that lies inside the clip. The input gradient (dx) is the same conv
    with Ci and Co swapped: the same bytes and FLOPs."""
    b, t, h, w, ci = shape

    def inside(n, k):
        return sum(max(0, n - abs(d - (k - 1) // 2)) for d in range(k))
    taps = b * inside(t, kernel[0]) * inside(h, kernel[1]) * inside(
        w, kernel[2])
    nbytes = (b * t * h * w * (ci + co) + math.prod(kernel) * ci * co) * elem
    return nbytes, 2 * taps * ci * co


class Calls(dict):
    """{family: [geometry of each call, in forward order]}; a family with
    no call reads []."""

    def __missing__(self, family):
        return []


def geometry(model, clip_shape, batch):
    """The calls of the hand-written functions in one forward of the
    reference ``model`` (moved to ``meta``) at ``batch`` clips: every
    module that defines ``kernel_call(args)`` reports its call's family
    and geometry (or None) from a forward hook. The reference's own:
    {'fused_bottleneck': [(shape, k, s, e, co, use_se)], 'attention':
    [(s, h, n, d)], 'folded_conv': [(shape, co, kernel)]}, shapes
    channels-last."""
    model = model.to("meta").eval()
    calls = Calls()

    def on_call(m, args, out):
        call = m.kernel_call(args)
        if call is not None:
            family, geo = call
            calls.setdefault(family, []).append(geo)

    hooks = [m.register_forward_hook(on_call) for m in model.modules()
             if callable(getattr(m, "kernel_call", None))]
    try:
        with torch.no_grad():
            model(torch.empty((batch, 3) + tuple(clip_shape),
                              device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


# ------------------------- least time of a window's calls, per family

def fused_bottleneck_least_ms(win):
    """The profiled forwards' fused bottleneck calls, each counted once
    (``fused_bottleneck_work``)."""
    per_forward = sum(least_ms(*fused_bottleneck_work(*c))
                      for c in win.calls["fused_bottleneck"])
    return win.forwards * per_forward


def flash_attention_least_ms(win):
    """The forwards' flash forwards (with the lse where the window trains)
    and the backwards' flash backwards, each as one function."""
    train = win.backwards > 0
    fwd = sum(least_ms(*flash_work(*c, with_lse=train))
              for c in win.calls["attention"])
    bwd = sum(least_ms(*flash_backward_work(*c))
              for c in win.calls["attention"])
    return win.forwards * fwd + win.backwards * bwd


def folded_conv_least_ms(win):
    """The forwards' folded convs and the backwards' input gradients, the
    same work each."""
    per = sum(least_ms(*conv_work(*c)) for c in win.calls["folded_conv"])
    return (win.forwards + win.backwards) * per
