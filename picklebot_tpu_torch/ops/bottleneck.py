"""Inverted-bottleneck blocks, channels-last.

Counterpart of ``Bottleneck3D`` and ``Bottleneck2D`` in
``picklebot_tpu/ops/bottleneck.py``. ``Bottleneck3D`` keeps the
reference's quirks for checkpoint parity:

  * the depthwise kernel is (1, k, k), but the integer stride and the
    padding k//2 act on T as well (T grows by 2*(k//2) on stride-1 blocks);
  * there is no residual connection;
  * BatchNorm and the nonlinearity come after the projection;
  * channel dropout at the end (train only).

On a CUDA tensor the conv chain (expand, depthwise, SE, project) runs in
the fused kernels of ``ops/fused_bottleneck.py`` (in training through its
``FusedBottleneckFn``, whose backward recomputes the plain chain); on the
CPU, or with ``kernels=False``, it runs the plain chain of modules. While
``torch.export`` traces, the kernels' custom ops are taken on the CPU too,
so that an exported program holds them whatever its device. The
folded forwards of the JAX package (``early_fold``, ``fold_span``) are
not ported.

``Bottleneck2D`` works on frames (B, H, W, C): expand 1x1 -> (k, k)
depthwise with a true 2-D stride and padding k//2 -> optional SE ->
project 1x1 -> BN -> nonlinearity, bias-free convs, no residual. The
reference builds a Dropout2d it never calls, so there is none. It is the
plain chain of modules only, as in the JAX package, whose forward reaches
no kernel.
"""

from __future__ import annotations

from typing import Callable

from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.ops.conv import Conv2d, Conv3d
from picklebot_tpu_torch.ops.fused_bottleneck import fused_bottleneck
from picklebot_tpu_torch.ops.linear import ChannelDropout
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.ops.se import SEBlock


class Bottleneck3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 expanded_channels: int, stride: int = 1,
                 use_se: bool = False, kernel_size: int = 3,
                 nonlinearity: Callable = act.hardswish,
                 dropout: float = 0.0):
        super().__init__()
        self.stride = stride
        self.kernel_size = kernel_size
        self.use_se = use_se
        self.pointwise_conv1 = Conv3d(in_channels, expanded_channels, 1,
                                      bias=False)
        self.depthwise_conv = Conv3d(
            expanded_channels, expanded_channels,
            kernel_size=(1, kernel_size, kernel_size), stride=stride,
            padding=kernel_size // 2, groups=expanded_channels, bias=False)
        self.squeeze_excite = SEBlock(expanded_channels) if use_se else None
        self.pointwise_conv2 = Conv3d(expanded_channels, out_channels, 1,
                                      bias=False)
        self.batchnorm = BatchNorm(out_channels)
        self.nonlinearity = nonlinearity
        self.dropout = ChannelDropout(dropout)

    def kernel_weights(self, dtype):
        """The chain's weights in the kernel's layout and ``dtype``:
        w1 (C, E), wd (k, k, E), w2 (E, Co), then the SE MLP's four (or
        four Nones)."""
        convs = (self.pointwise_conv1, self.depthwise_conv,
                 self.pointwise_conv2)
        if any(c.bias is not None for c in convs):
            # the kernels skip T's zero padding frames, exact only
            # because a bias-free expand maps them to zero
            raise ValueError("the fused bottleneck takes bias-free convs")
        e = self.pointwise_conv1.out_channels
        k = self.kernel_size
        w1 = self.pointwise_conv1.weight.view(e, -1).t()
        wd = self.depthwise_conv.weight.view(e, k, k).permute(1, 2, 0)
        w2 = self.pointwise_conv2.weight.view(-1, e).t()
        se = (self.squeeze_excite.mlp_weights() if self.use_se
              else (None,) * 4)
        return tuple(w.to(dtype).contiguous() for w in (w1, wd, w2)) + se

    def forward(self, x, kernels: bool = True):
        if kernels and (x.is_cuda or library.use_ops()):
            x = fused_bottleneck(x.contiguous(),
                                 *self.kernel_weights(x.dtype),
                                 self.kernel_size, self.stride, self.use_se)
        else:
            x = self.depthwise_conv(self.pointwise_conv1(x))
            if self.squeeze_excite is not None:
                x = self.squeeze_excite(x)
            x = self.pointwise_conv2(x)
        return self.dropout(self.nonlinearity(self.batchnorm(x)))


class Bottleneck2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 expanded_channels: int, stride: int = 1,
                 use_se: bool = False, kernel_size: int = 3,
                 nonlinearity: Callable = act.hardswish):
        super().__init__()
        e = expanded_channels
        self.pointwise_conv1 = Conv2d(in_channels, e, 1, bias=False)
        self.depthwise_conv = Conv2d(e, e, kernel_size, stride=stride,
                                     padding=kernel_size // 2, groups=e,
                                     bias=False)
        self.squeeze_excite = SEBlock(e, rank=4) if use_se else None
        self.pointwise_conv2 = Conv2d(e, out_channels, 1, bias=False)
        self.batchnorm = BatchNorm(out_channels)
        self.nonlinearity = nonlinearity

    def forward(self, x):
        x = self.depthwise_conv(self.pointwise_conv1(x))
        if self.squeeze_excite is not None:
            x = self.squeeze_excite(x)
        return self.nonlinearity(self.batchnorm(self.pointwise_conv2(x)))
