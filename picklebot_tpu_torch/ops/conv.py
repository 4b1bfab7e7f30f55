"""Convolutions on channels-last activations.

Counterpart of ``picklebot_tpu/ops/conv.py``. Activations are
(B, T, H, W, C) (``Conv3d``, ``CausalConv3d``) or (B, H, W, C) (``Conv2d``)
as in the JAX package; the weight keeps the reference's torch layout
(O, I/groups, k...) so state dicts load as they are.
``Conv3d`` serves the stride-2 stems, the 1x1 head convs, MoViNet's
per-axis depthwise convs and MobileViT's dense 3x3x3 ``conv1``/``conv4``;
the plain bottleneck chain uses its pointwise and depthwise forms. A 1x1x1
conv is a matmul over the channel axis. A dense (groups=1) stride-1
'same'-padded conv with more than one tap that
``ops.folded_conv.folded_conv_s1_eligible`` accepts (MobileViT's
``conv1``/``conv4``) runs, on a CUDA tensor, in the hand-written kernel of
``ops/folded_conv.py`` straight on the channels-last tensor; with
``kernels=False``, on the CPU, and for every other conv (strided, grouped,
narrow) it is ``F.conv3d`` on a channels-first view, which the JAX package
also leaves to the compiler. ``CausalConv3d`` is MoViNet's streaming
depthwise conv: a grouped ``Conv3d`` (never the kernel) whose temporal
context comes from zero padding or from a carried buffer. ``Conv2d`` serves
the per-frame 2-D models: a matmul at 1x1, ``F.conv2d`` otherwise.

Parameters are f32; each op casts them to its input's dtype (the compute
dtype of ``core.policy``).
"""

from __future__ import annotations

import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.ops.folded_conv import (folded_conv_s1,
                                                 folded_conv_s1_eligible)

IntOrTuple = Union[int, Tuple[int, ...]]


def _ntuple(v: IntOrTuple, n: int) -> Tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        assert len(v) == n, f"expected a {n}-tuple, got {v}"
        return tuple(int(a) for a in v)
    return (int(v),) * n


def torch_default_uniform_(t: torch.Tensor, fan_in: int,
                           generator: torch.Generator):
    """nn.Conv3d's default init for weights and biases alike:
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (kaiming_uniform with a=sqrt(5))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def pointwise_conv(x, w_io):
    """1x1x1 conv on (..., I) with a weight matrix (I, O), in x's dtype."""
    return torch.matmul(x, w_io.to(x.dtype))


def depthwise_conv(x, wd, stride: int):
    """Bottleneck3D's depthwise conv on (B, T, H, W, E) with wd (k, k, E):
    temporal kernel 1, but the integer stride and the padding k//2 act on T
    as well (the reference's quirk, kept for checkpoint parity)."""
    k, e = wd.shape[0], wd.shape[-1]
    w = wd.to(x.dtype).permute(2, 0, 1).reshape(e, 1, 1, k, k)
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, stride=stride,
                   padding=k // 2, groups=e)
    return out.permute(0, 2, 3, 4, 1).contiguous()


class Conv3d(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple, stride: IntOrTuple = 1,
                 padding: IntOrTuple = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        assert in_channels % groups == 0 and out_channels % groups == 0
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, 3)
        self.stride = _ntuple(stride, 3)
        self.padding = _ntuple(padding, 3)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.fan_in = (in_channels // groups) * math.prod(self.kernel_size)

    def reset_parameters(self, generator: torch.Generator):
        torch_default_uniform_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_default_uniform_(self.bias, self.fan_in, generator)

    @property
    def is_pointwise(self) -> bool:
        return (self.kernel_size == (1, 1, 1) and self.stride == (1, 1, 1)
                and self.padding == (0, 0, 0) and self.groups == 1)

    def _same_pads(self):
        return tuple((p, p) for p in self.padding)

    def takes_folded_kernel(self, x) -> bool:
        """Whether ``forward(x)`` on the card runs the folded-conv kernel:
        a dense conv with more than one tap that the kernel's predicate
        accepts."""
        w_shape = self.kernel_size + (self.in_channels, self.out_channels)
        return (self.groups == 1 and math.prod(self.kernel_size) > 1
                and folded_conv_s1_eligible(x.shape, w_shape, self.stride,
                                            self._same_pads()))

    def forward(self, x, kernels: bool = True):
        """``kernels=False`` keeps an eligible conv on ``F.conv3d`` even on
        the card (the plain path the kernel is held against)."""
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.is_pointwise:
            out = pointwise_conv(
                x, self.weight.view(self.out_channels, self.in_channels).t())
            return out if bias is None else out + bias
        if kernels and (x.is_cuda or library.use_ops()) and \
                self.takes_folded_kernel(x):
            w = self.weight.permute(2, 3, 4, 1, 0).to(x.dtype).contiguous()
            out = folded_conv_s1(x.contiguous(), w, self._same_pads())
            return out if bias is None else out + bias
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                       bias, self.stride, self.padding, groups=self.groups)
        return out.permute(0, 2, 3, 4, 1).contiguous()


class CausalConv3d(Conv3d):
    """Temporally causal bias-free 3-D conv, padding (0, kH//2, kW//2),
    with ``t_context`` = kT - 1 frames of left context. Its parameters are
    a ``Conv3d``'s, so MoViNet's offline and streaming forms share their
    state-dict keys.

    ``forward(x)`` left-pads T with zeros (a whole clip). ``forward(x,
    buffer)`` puts the buffer, the last ``t_context`` input frames of the
    previous chunk, in front and returns ``(out, new_buffer)``; with
    ``t_context`` 0 the buffer comes back unchanged."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple, stride: IntOrTuple = 1,
                 groups: int = 1):
        ks = _ntuple(kernel_size, 3)
        super().__init__(in_channels, out_channels, ks, stride=stride,
                         padding=(0, ks[1] // 2, ks[2] // 2), groups=groups,
                         bias=False)
        self.t_context = ks[0] - 1

    def forward(self, x, buffer=None):
        t = self.t_context
        if t == 0:
            x_in = x
        elif buffer is None:
            x_in = F.pad(x, (0, 0, 0, 0, 0, 0, t, 0))
        else:
            x_in = torch.cat([buffer.to(x.dtype), x], dim=1)
        out = super().forward(x_in)
        if buffer is None:
            return out
        return out, (x_in[:, -t:] if t > 0 else buffer)


class Conv2d(nn.Module):
    """2-D conv on (B, H, W, C), weight (O, I/groups, kH, kW)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOrTuple, stride: IntOrTuple = 1,
                 padding: IntOrTuple = 0, groups: int = 1, bias: bool = True):
        super().__init__()
        assert in_channels % groups == 0 and out_channels % groups == 0
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = _ntuple(kernel_size, 2)
        self.stride = _ntuple(stride, 2)
        self.padding = _ntuple(padding, 2)
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(
            (out_channels, in_channels // groups) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        self.fan_in = (in_channels // groups) * math.prod(self.kernel_size)

    def reset_parameters(self, generator: torch.Generator):
        torch_default_uniform_(self.weight, self.fan_in, generator)
        if self.bias is not None:
            torch_default_uniform_(self.bias, self.fan_in, generator)

    @property
    def is_pointwise(self) -> bool:
        return (self.kernel_size == (1, 1) and self.stride == (1, 1)
                and self.padding == (0, 0) and self.groups == 1)

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        if self.is_pointwise:
            out = pointwise_conv(
                x, self.weight.view(self.out_channels, self.in_channels).t())
            return out if bias is None else out + bias
        out = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype), bias,
                       self.stride, self.padding, groups=self.groups)
        return out.permute(0, 2, 3, 1).contiguous()
