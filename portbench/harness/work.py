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


def geometry(model, clip_shape, batch):
    """The calls of the hand-written functions in one forward of the
    reference ``model`` (moved to ``meta``) at ``batch`` clips, read
    from forward hooks: {'fused_bottleneck': [(shape, k, s, e, co,
    use_se)], 'attention': [(s, h, n, d)], 'folded_conv': [(shape, co,
    kernel)]}, shapes channels-last."""
    from portbench.reference import models as R
    model = model.to("meta").eval()
    calls = {"fused_bottleneck": [], "attention": [], "folded_conv": []}

    def on_bottleneck(m, args, out):
        b, c, t, h, w = args[0].shape
        calls["fused_bottleneck"].append(
            ((b, t, h, w, c), m.kernel_size, m.stride,
             m.pointwise_conv1.out_channels,
             m.pointwise_conv2.out_channels, m.use_se))

    def on_attention(m, args, out):
        x = args[0]
        calls["attention"].append((math.prod(x.shape[:-2]), m.heads,
                                   x.shape[-2],
                                   m.to_qkv.out_features // 3 // m.heads))

    def on_conv(m, args, out):
        b, c, t, h, w = args[0].shape
        calls["folded_conv"].append(((b, t, h, w, c), m.out_channels,
                                     tuple(m.kernel_size)))

    hooks = []
    for m in model.modules():
        if isinstance(m, R.Bottleneck3D):
            hooks.append(m.register_forward_hook(on_bottleneck))
        elif isinstance(m, R.Attention):
            hooks.append(m.register_forward_hook(on_attention))
        elif isinstance(m, R.Conv3d) and takes_folded_conv(m):
            hooks.append(m.register_forward_hook(on_conv))
    try:
        with torch.no_grad():
            model(torch.empty((batch, 3) + tuple(clip_shape),
                              device="meta"))
    finally:
        for h in hooks:
            h.remove()
    return calls


def takes_folded_conv(conv) -> bool:
    """The hand-written conv's domain: dense, stride 1, odd kernels with
    'same' padding and more than one tap, at least 32 channels in and
    out."""
    k = tuple(conv.kernel_size)
    return (conv.groups == 1 and tuple(conv.stride) == (1, 1, 1)
            and math.prod(k) > 1 and all(x % 2 for x in k)
            and tuple(conv.padding) == tuple(x // 2 for x in k)
            and conv.in_channels >= 32 and conv.out_channels >= 32)
