"""MoViNet-A2 video classifier (offline, whole clips), channels-last.

Counterpart of ``MoviNetBottleneck`` and ``MoViNetA2`` in
``picklebot_tpu/models/movinet.py`` (plain forward), with the reference's
module tree, so its state dict has the reference keys: block1 = (Conv3d
3->16 (1,3,3) stride (1,2,2), BN, hardswish); block2-6 = 26 bottlenecks
(expand 1x1 -> depthwise conv with a per-axis kernel, (3,3,3), (5,3,3),
(1,5,5) or (1,3,3), explicit symmetric padding -> SE -> project 1x1 -> BN
-> hardswish); conv = (1x1 Conv3d 144->640, BN, hardswish, channel
dropout); classifier = (global average pool, flatten, Linear 640->2048,
BatchNorm over (B, 2048), hardswish, dropout, Linear 2048->classes).
3,992,289 parameters at 13 classes.

This block is not the fused bottleneck of ``ops/fused_bottleneck.py``
(whose depthwise kernel is (1,k,k) with a temporal quirk): its convs are
matmuls and cuDNN depthwise convs, as the JAX package leaves them to XLA,
and the model runs no hand-written kernel. The causal (streaming) form,
``MoViNetA2Stream`` and the folded forwards are not ported (ROADMAP.md).

Init, from a ``torch.Generator`` seed: kaiming-uniform(fan_in, relu)
convs, xavier-uniform linears with zero biases, PyTorch's default for the
SE layers, BatchNorm at identity statistics.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import (ChannelDropout, Dropout,
                                            GlobalAvgPool, Linear)
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.ops.se import SEBlock


class MoviNetBottleneck(nn.Module):
    def __init__(self, in_channels, out_channels, expanded_channels,
                 kernel_size, stride=(1, 1, 1), padding=None,
                 use_se: bool = True):
        super().__init__()
        kt, kh, kw = kernel_size
        pad = padding if padding is not None else (kt - 1, kh // 2, kw // 2)
        self.expand = Conv3d(in_channels, expanded_channels, 1, bias=False)
        self.conv = Conv3d(expanded_channels, expanded_channels, kernel_size,
                           stride=stride, padding=pad,
                           groups=expanded_channels, bias=False)
        self.squeeze_excite = SEBlock(expanded_channels) if use_se else None
        self.project = Conv3d(expanded_channels, out_channels, 1, bias=False)
        self.batchnorm = BatchNorm(out_channels)

    def forward(self, x):
        x = self.conv(self.expand(x))
        if self.squeeze_excite is not None:
            x = self.squeeze_excite(x)
        return act.hardswish(self.batchnorm(self.project(x)))


def _a2_blocks():
    """The A2 stage table: (cin, cout, expanded, kernel, stride, padding)."""
    B = MoviNetBottleneck
    s1, s2 = (1, 1, 1), (1, 2, 2)
    k333, p333 = (3, 3, 3), (1, 1, 1)
    k533, p533 = (5, 3, 3), (2, 1, 1)
    k155, p155 = (1, 5, 5), (0, 2, 2)
    return (
        [B(16, 16, 40, k155, s2, p155), B(16, 16, 40, k333, s1, p333),
         B(16, 16, 64, k333, s1, p333)],
        [B(16, 40, 96, k333, s2, p333), B(40, 40, 120, k333, s1, p333),
         B(40, 40, 96, k333, s1, p333), B(40, 40, 96, k333, s1, p333),
         B(40, 40, 120, k333, s1, p333)],
        [B(40, 72, 240, k533, s2, p533), B(72, 72, 160, k333, s1, p333),
         B(72, 72, 240, k333, s1, p333), B(72, 72, 192, k333, s1, p333),
         B(72, 72, 240, k333, s1, p333)],
        [B(72, 72, 240, k533, s1, p533), B(72, 72, 240, k333, s1, p333),
         B(72, 72, 240, k333, s1, p333), B(72, 72, 240, k333, s1, p333),
         B(72, 72, 144, k155, s1, p155), B(72, 72, 240, k333, s1, p333)],
        [B(72, 144, 480, k533, s2, p533), B(144, 144, 384, k155, s1, p155),
         B(144, 144, 384, k155, s1, p155), B(144, 144, 480, k155, s1, p155),
         B(144, 144, 480, k155, s1, p155), B(144, 144, 480, k333, s1, p333),
         B(144, 144, 576, (1, 3, 3), s1, (0, 1, 1))],
    )


class MoViNetA2(nn.Module):
    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        self.block1 = nn.Sequential(
            Conv3d(3, 16, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1),
                   bias=False),
            BatchNorm(16), act.Activation(act.hardswish))
        b2, b3, b4, b5, b6 = _a2_blocks()
        self.block2 = nn.Sequential(*b2)
        self.block3 = nn.Sequential(*b3)
        self.block4 = nn.Sequential(*b4)
        self.block5 = nn.Sequential(*b5)
        self.block6 = nn.Sequential(*b6)
        self.conv = nn.Sequential(
            Conv3d(144, 640, 1, bias=False), BatchNorm(640),
            act.Activation(act.hardswish), ChannelDropout(0.2))
        self.classifier = nn.Sequential(
            GlobalAvgPool(), nn.Identity(), Linear(640, 2048),
            BatchNorm(2048), act.Activation(act.hardswish), Dropout(0.2),
            Linear(2048, num_classes))
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            with torch.no_grad():
                if isinstance(m, Conv3d):
                    # kaiming_uniform_(mode="fan_in", nonlinearity="relu")
                    bound = math.sqrt(6.0 / m.fan_in)
                    m.weight.uniform_(-bound, bound, generator=g)
                elif isinstance(m, Linear):
                    bound = math.sqrt(6.0 / (m.in_features + m.out_features))
                    m.weight.uniform_(-bound, bound, generator=g)
                    m.bias.zero_()
                elif m is not self and hasattr(m, "reset_parameters"):
                    m.reset_parameters(g)

    def forward(self, x, kernels: bool = True):
        """``kernels`` is accepted so that callers treat every model of the
        registry alike; this model runs no hand-written kernel, so both
        values run the same code."""
        x = self.block1(x)
        for stage in (self.block2, self.block3, self.block4, self.block5,
                      self.block6):
            x = stage(x)
        return self.classifier(self.conv(x))
