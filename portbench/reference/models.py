"""Plain reference models: MobileNetLarge3D and MobileViT (v1), channels
first, in plain PyTorch modules.

Written from the architecture of hbfreed/Picklebot (``mobilenet.py``,
``mobilevit.py``) as the port runs it, with the same state-dict keys, so
one seeded state dict loads into both. Nothing here imports the program.
The published quirks are kept: the bottleneck's depthwise kernel is
(1, k, k) but its stride and padding k//2 act on T too; no residual in a
bottleneck; BatchNorm and the nonlinearity follow the projection; whole
channels drop after it in training. MobileViT's blocks pad (T, H, W) to
the (2, 2, 2) patch, attend over 8 sequences of patch positions with a
pre-LayerNorm (no affine) transformer of 8 heads of 16 whose heads merge
as (N, H*D), crop, and fuse with the block's input.

``precision`` selects how every convolution and matrix product runs:
``"f32"`` (the reference: float32 with TF32 off, see ``f32_exact``) or
``"fp8"`` (the control: operands rounded to float8 e4m3 with one scale
per tensor, gradients to e5m2, products in float32).

Train-mode channel dropout draws ``torch.rand((B, 1, 1, 1, C))`` from
the generator given to ``forward``, in module order, the masks the
program's train step draws from the same generator state.

``Conv3d``, ``Bottleneck3D`` and ``Attention`` stand for the program's
hand-written functions where it routes them there: each reports that
call's family and geometry (``kernel_call``), which the benchmark's
work counts read.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX, E5M2_MAX = 448.0, 57344.0


@contextlib.contextmanager
def f32_exact():
    """Float32 convolutions and matmuls without TF32, flags restored."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def _round_fp8(t, dtype, top):
    amax = t.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return ((t / scale).to(dtype).to(t.dtype)) * scale


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 with a per-tensor scale; backward: the gradient in
    e5m2 with its own scale."""

    @staticmethod
    def forward(ctx, t):
        return _round_fp8(t, torch.float8_e4m3fn, E4M3_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round_fp8(g, torch.float8_e5m2, E5M2_MAX)


def operand(t, precision):
    return _Fp8.apply(t) if precision == "fp8" else t


class Conv3d(nn.Conv3d):
    precision = "f32"

    def forward(self, x):
        p = self.precision
        bias = None if self.bias is None else operand(self.bias, p)
        return F.conv3d(operand(x, p), operand(self.weight, p), bias,
                        self.stride, self.padding, self.dilation,
                        self.groups)

    def kernel_call(self, args):
        """The folded conv's call (input shape channels-last, Co, kernel)
        where the conv lies in its domain, else None."""
        if not takes_folded_conv(self):
            return None
        b, c, t, h, w = args[0].shape
        return "folded_conv", ((b, t, h, w, c), self.out_channels,
                               tuple(self.kernel_size))


def takes_folded_conv(conv) -> bool:
    """The hand-written conv's domain: dense, stride 1, odd kernels with
    'same' padding and more than one tap, at least 32 channels in and
    out."""
    k = tuple(conv.kernel_size)
    return (conv.groups == 1 and tuple(conv.stride) == (1, 1, 1)
            and math.prod(k) > 1 and all(x % 2 for x in k)
            and tuple(conv.padding) == tuple(x // 2 for x in k)
            and conv.in_channels >= 32 and conv.out_channels >= 32)


class Linear(nn.Linear):
    precision = "f32"

    def forward(self, x):
        p = self.precision
        bias = None if self.bias is None else operand(self.bias, p)
        return F.linear(operand(x, p), operand(self.weight, p), bias)


def hardswish(x):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardsigmoid(x):
    return torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def silu(x):
    return x * torch.sigmoid(x)


class Act(nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class SqueezeExcite(nn.Module):
    """Mean over (T, H, W) -> 1x1 conv E -> E/4 -> relu -> 1x1 conv ->
    hardsigmoid -> channel scale; keys ``se.1`` and ``se.3``."""

    def __init__(self, e):
        super().__init__()
        self.se = nn.Sequential(nn.Identity(), Conv3d(e, e // 4, 1),
                                nn.ReLU(), Conv3d(e // 4, e, 1))

    def forward(self, x):
        s = x.mean(dim=(2, 3, 4), keepdim=True)
        s = self.se[3](torch.relu(self.se[1](s)))
        return x * hardsigmoid(s)


class Bottleneck3D(nn.Module):
    def __init__(self, cin, cout, e, stride=1, use_se=False, kernel_size=3,
                 nonlinearity=hardswish, dropout=0.0):
        super().__init__()
        k = kernel_size
        self.kernel_size, self.stride, self.use_se = k, stride, use_se
        self.pointwise_conv1 = Conv3d(cin, e, 1, bias=False)
        self.depthwise_conv = Conv3d(e, e, (1, k, k), stride=stride,
                                     padding=k // 2, groups=e, bias=False)
        self.squeeze_excite = SqueezeExcite(e) if use_se else None
        self.pointwise_conv2 = Conv3d(e, cout, 1, bias=False)
        self.batchnorm = nn.BatchNorm3d(cout)
        self.nonlinearity = nonlinearity
        self.p = dropout

    def forward(self, x, generator=None):
        x = self.depthwise_conv(self.pointwise_conv1(x))
        if self.squeeze_excite is not None:
            x = self.squeeze_excite(x)
        x = self.nonlinearity(self.batchnorm(self.pointwise_conv2(x)))
        if self.training and self.p > 0:
            keep = 1.0 - self.p
            b, c = x.shape[:2]
            mask = torch.rand((b, 1, 1, 1, c), generator=generator,
                              device=x.device) < keep
            mask = mask.permute(0, 4, 1, 2, 3)
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return x

    def kernel_call(self, args):
        """The fused bottleneck's call: (input shape channels-last, k,
        stride, E, Co, SE)."""
        b, c, t, h, w = args[0].shape
        return "fused_bottleneck", ((b, t, h, w, c), self.kernel_size,
                                    self.stride,
                                    self.pointwise_conv1.out_channels,
                                    self.pointwise_conv2.out_channels,
                                    self.use_se)


def _conv_bn_act(cin, cout, k, stride=1, padding=0, fn=hardswish):
    return nn.Sequential(Conv3d(cin, cout, k, stride=stride,
                                padding=padding),
                         nn.BatchNorm3d(cout), Act(fn))


class MobileNetLarge3D(nn.Module):
    """4,205,675 parameters at 13 classes."""

    def __init__(self, num_classes=13):
        super().__init__()
        B = Bottleneck3D

        def relu(x):
            return torch.clamp_min(x, 0)

        self.block1 = _conv_bn_act(3, 16, 3, stride=2, padding=1)
        self.block2 = nn.Sequential(
            B(16, 16, 16, 1, nonlinearity=relu, dropout=0.2),
            B(16, 24, 64, 2, nonlinearity=relu, dropout=0.2),
            B(24, 24, 72, 1, nonlinearity=relu, dropout=0.2))
        self.block3 = nn.Sequential(*[
            B(cin, 40, e, s, use_se=True, kernel_size=5, nonlinearity=relu,
              dropout=0.2) for cin, e, s in ((24, 72, 2), (40, 120, 1),
                                             (40, 120, 1))])
        self.block4 = nn.Sequential(
            B(40, 80, 240, 2, dropout=0.2), B(80, 80, 240, 1, dropout=0.2),
            B(80, 80, 184, 1, dropout=0.2), B(80, 80, 184, 1, dropout=0.2),
            B(80, 112, 480, 1, use_se=True, dropout=0.2),
            B(112, 112, 672, 1, use_se=True, dropout=0.2))
        self.block5 = nn.Sequential(*[
            B(cin, 160, e, s, use_se=True, kernel_size=5, dropout=0.2)
            for cin, e, s in ((112, 672, 2), (160, 960, 1), (160, 960, 1))])
        self.block6 = _conv_bn_act(160, 960, 1)
        self.classifier = nn.Sequential(
            nn.Identity(), Conv3d(960, 1280, 1), Act(hardswish),
            Conv3d(1280, num_classes, 1))

    def bottlenecks(self):
        for stage in (self.block2, self.block3, self.block4, self.block5):
            yield from stage

    def forward(self, x, generator=None):
        """x (B, C, T, H, W) -> (B, classes)."""
        x = self.block1(x)
        for b in self.bottlenecks():
            x = b(x, generator)
        x = self.block6(x).mean(dim=(2, 3, 4), keepdim=True)
        c = self.classifier
        return c[3](c[2](c[1](x))).flatten(1)


def conv_bn_silu(cin, cout, k, stride=1, padding=0):
    """Conv (bias-free) -> BatchNorm without affine -> SiLU."""
    return nn.Sequential(Conv3d(cin, cout, k, stride=stride,
                                padding=padding, bias=False),
                         nn.BatchNorm3d(cout, affine=False), Act(silu))


class Attention(nn.Module):
    """Pre-LN (no affine) multi-head attention on (..., N, D)."""

    def __init__(self, dim, heads=8, dim_head=16):
        super().__init__()
        self.heads, self.scale = heads, dim_head ** -0.5
        self.to_qkv = Linear(dim, 3 * heads * dim_head, bias=False)
        self.to_out = nn.Sequential(Linear(heads * dim_head, dim,
                                           bias=False))

    def forward(self, x):
        p = self.to_qkv.precision
        h = F.layer_norm(x, x.shape[-1:], eps=1e-5)
        q, k, v = (t.unflatten(-1, (self.heads, -1)).transpose(-2, -3)
                   for t in self.to_qkv(h).chunk(3, dim=-1))
        s = torch.matmul(operand(q, p), operand(k, p).transpose(-1, -2))
        a = torch.matmul(operand(torch.softmax(s * self.scale, dim=-1), p),
                         operand(v, p))
        return self.to_out(a.transpose(-2, -3).flatten(-2))

    def kernel_call(self, args):
        """The flash attention's call: (sequences, heads, N, head dim)."""
        x = args[0]
        return "attention", (math.prod(x.shape[:-2]), self.heads,
                             x.shape[-2],
                             self.to_qkv.out_features // 3 // self.heads)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.net = nn.Sequential(Linear(dim, hidden, bias=False), Act(silu),
                                 nn.Identity(),
                                 Linear(hidden, dim, bias=False))

    def forward(self, x):
        return self.net[3](silu(self.net[0](x)))


class Transformer(nn.Module):
    def __init__(self, dim, depth, hidden):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([Attention(dim), FeedForward(dim, hidden)])
            for _ in range(depth)])

    def forward(self, x):
        for attn, ff in self.layers:
            x = attn(x) + x
            x = ff(x) + x
        return x


class MobileViTBlock(nn.Module):
    def __init__(self, dim, depth, channel, hidden, kernel_size=3):
        super().__init__()
        self.conv1 = conv_bn_silu(channel, channel, kernel_size, padding=1)
        self.conv2 = conv_bn_silu(channel, dim, 1)
        self.transformer = Transformer(dim, depth, hidden)
        self.conv3 = conv_bn_silu(dim, channel, 1)
        self.conv4 = conv_bn_silu(2 * channel, channel, kernel_size,
                                  padding=1)

    def forward(self, x):
        y = x
        x = self.conv2(self.conv1(x)).permute(0, 2, 3, 4, 1)
        b, t, h, w, d = x.shape
        tp, hp, wp = -(-t // 2), -(-h // 2), -(-w // 2)
        x = F.pad(x, (0, 0, 0, 2 * wp - w, 0, 2 * hp - h, 0, 2 * tp - t))
        # 8 sequences, one per position in the (2, 2, 2) patch
        x = x.reshape(b, tp, 2, hp, 2, wp, 2, d).permute(
            0, 2, 4, 6, 1, 3, 5, 7).reshape(b, 8, tp * hp * wp, d)
        x = self.transformer(x)
        x = x.reshape(b, 2, 2, 2, tp, hp, wp, d).permute(
            0, 4, 1, 5, 2, 6, 3, 7).reshape(b, 2 * tp, 2 * hp, 2 * wp, d)
        x = self.conv3(x[:, :t, :h, :w].permute(0, 4, 1, 2, 3))
        return self.conv4(torch.cat([x, y], dim=1))


class MobileViT(nn.Module):
    """MobileViT v1 with ``dims`` (3) and ``channels`` (11); expansion 4,
    depths (2, 4, 3). MobileViT-s: 8,453,136 parameters at 13 classes."""

    def __init__(self, dims, channels, num_classes=13):
        super().__init__()
        ch, B = list(channels), Bottleneck3D
        self.conv1 = conv_bn_silu(3, ch[0], 3, stride=2, padding=1)
        self.stem = nn.ModuleList([
            B(ch[0], ch[1], ch[0] * 4, 1), B(ch[1], ch[2], ch[1] * 4, 2),
            B(ch[2], ch[3], ch[2] * 4, 1), B(ch[2], ch[3], ch[2] * 4, 1)])
        # the published expansions: trunk[1]'s from ch[7], trunk[2]'s a
        # literal 4
        self.trunk = nn.ModuleList([
            nn.Sequential(B(ch[3], ch[4], ch[3] * 4, 2),
                          MobileViTBlock(dims[0], 2, ch[5], dims[0] * 2)),
            nn.Sequential(B(ch[5], ch[6], ch[7] * 4, 2),
                          MobileViTBlock(dims[1], 4, ch[7], dims[1] * 4)),
            nn.Sequential(B(ch[7], ch[8], ch[7] * 4, 2),
                          MobileViTBlock(dims[2], 3, ch[9], dims[2] * 4))])
        self.to_logits = nn.Sequential(
            conv_bn_silu(ch[-2], ch[-1], 1), nn.Identity(),
            Linear(ch[-1], num_classes, bias=False))

    def bottlenecks(self):
        yield from self.stem
        for stage in self.trunk:
            yield stage[0]

    def forward(self, x, generator=None):
        x = self.conv1(x)
        for b in self.stem:
            x = b(x, generator)
        for bottleneck, block in self.trunk:
            x = block(bottleneck(x, generator))
        x = self.to_logits[0](x).mean(dim=(2, 3, 4))
        return self.to_logits[2](x)


def build(model_name, num_classes, dims=None, channels=None):
    """The reference model of a configuration's ``model_name``, for a
    configuration that names no reference file of its own
    (``harness/references.py``)."""
    if model_name == "MobileNetLarge3D":
        return MobileNetLarge3D(num_classes)
    if model_name == "MobileViT":
        return MobileViT(dims, channels, num_classes)
    raise ValueError(f"no plain reference for {model_name!r}")


def set_precision(model, precision):
    """Every convolution and matmul of ``model`` in ``precision``."""
    if precision not in ("f32", "fp8"):
        raise ValueError(f"precision {precision!r} (f32 or fp8)")
    for m in model.modules():
        if isinstance(m, (Conv3d, Linear)):
            m.precision = precision
    return model
