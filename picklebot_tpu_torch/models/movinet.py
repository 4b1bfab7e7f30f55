"""MoViNet-A2 video classifier, offline (whole clips) and streaming.

Counterpart of ``MoviNetBottleneck``, ``MoViNetA2`` and ``MoViNetA2Stream``
in ``picklebot_tpu/models/movinet.py`` (plain forward), with the reference's
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
and the model runs no hand-written kernel. The folded forwards are not
ported.

``MoViNetA2Stream`` is the causal form: every depthwise conv is a
``CausalConv3d`` (zero left context in T, or the carried buffer), the
global pool a running mean over every frame seen. It has exactly the
offline model's parameters and state-dict keys, so one ``.pth`` loads into
either with ``strict=True``. The two forms differ in their temporal
padding, so their logits differ. The causal convs and the running pool
give the same result whatever the chunking, but the SE blocks pool the
frames of the chunk at hand (every axis but batch and channel, as in the
JAX package), so the stream form's logits depend on the chunking.

Init, from a ``torch.Generator`` seed: kaiming-uniform(fan_in, relu)
convs, xavier-uniform linears with zero biases, PyTorch's default for the
SE layers, BatchNorm at identity statistics.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.conv import CausalConv3d, Conv3d
from picklebot_tpu_torch.ops.linear import (ChannelDropout, Dropout,
                                            GlobalAvgPool, Linear)
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.ops.se import SEBlock


class MoviNetBottleneck(nn.Module):
    """``causal=True`` makes the depthwise conv a ``CausalConv3d`` (the
    padding argument is then unused); given a buffer, ``forward(x,
    buffer)`` returns ``(x, new_buffer)``, as ``CausalConv3d`` does."""

    def __init__(self, in_channels, out_channels, expanded_channels,
                 kernel_size, stride=(1, 1, 1), padding=None,
                 use_se: bool = True, causal: bool = False):
        super().__init__()
        e = expanded_channels
        self.expand = Conv3d(in_channels, e, 1, bias=False)
        if causal:
            self.conv = CausalConv3d(e, e, kernel_size, stride=stride,
                                     groups=e)
        else:
            kt, kh, kw = kernel_size
            pad = (padding if padding is not None
                   else (kt - 1, kh // 2, kw // 2))
            self.conv = Conv3d(e, e, kernel_size, stride=stride, padding=pad,
                               groups=e, bias=False)
        self.squeeze_excite = SEBlock(e) if use_se else None
        self.project = Conv3d(e, out_channels, 1, bias=False)
        self.batchnorm = BatchNorm(out_channels)

    def forward(self, x, buffer=None):
        x = self.expand(x)
        if buffer is None:
            x = self.conv(x)
        else:
            x, buffer = self.conv(x, buffer)
        if self.squeeze_excite is not None:
            x = self.squeeze_excite(x)
        x = act.hardswish(self.batchnorm(self.project(x)))
        return x if buffer is None else (x, buffer)


def _a2_blocks(causal: bool = False):
    """The A2 stage table: (cin, cout, expanded, kernel, stride, padding)."""
    def B(*args):
        return MoviNetBottleneck(*args, causal=causal)
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
    def __init__(self, num_classes: int = 2, seed: int = 0,
                 causal: bool = False):
        super().__init__()
        self.num_classes = num_classes
        self.block1 = nn.Sequential(
            Conv3d(3, 16, (1, 3, 3), stride=(1, 2, 2), padding=(0, 1, 1),
                   bias=False),
            BatchNorm(16), act.Activation(act.hardswish))
        b2, b3, b4, b5, b6 = _a2_blocks(causal)
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

    def stages(self):
        return (self.block2, self.block3, self.block4, self.block5,
                self.block6)

    def forward(self, x, kernels: bool = True):
        """``kernels`` is accepted so that callers treat every model of the
        registry alike; this model runs no hand-written kernel, so both
        values run the same code."""
        x = self.block1(x)
        for stage in self.stages():
            x = stage(x)
        return self.classifier(self.conv(x))


class MoViNetA2Stream(MoViNetA2):
    """Online inference with carried state:

        carry = model.init_stream(batch, h, w, dtype, device)
        for chunk in chunks:                      # (B, t, h, w, 3)
            logits, carry = model(chunk, carry)

    ``carry = (buffers, (pool_sum, count))``: each causal block's last
    ``t_context`` expanded input frames, and the running f32 sum of the
    per-frame pooled features (B, 640) with the f32 frame count.
    ``model(x)`` without a carry is one chunk holding the whole clip, from
    a zero carry (the server's path without --stream), and returns the
    logits only."""

    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__(num_classes, seed, causal=True)

    def blocks(self):
        return [b for stage in self.stages() for b in stage]

    def init_stream(self, batch: int, height: int, width: int,
                    dtype=torch.float32, device=None):
        """Zero buffers for frames of (height, width): each block's
        (B, t_context, h, w, E) at its input's size, h and w ceil-divided
        by the stem's stride 2 and then by each block's stride after its
        buffer is sized; the pool carry ((B, 640) f32 zeros, f32 0)."""
        h, w = -(-height // 2), -(-width // 2)
        buffers = []
        for block in self.blocks():
            conv = block.conv
            buffers.append(torch.zeros(
                (batch, conv.t_context, h, w, conv.in_channels), dtype=dtype,
                device=device))
            h, w = -(-h // conv.stride[1]), -(-w // conv.stride[2])
        pooled = (torch.zeros((batch, 640), dtype=torch.float32,
                              device=device),
                  torch.zeros((), dtype=torch.float32, device=device))
        return tuple(buffers), pooled

    def forward(self, x, carry=None, kernels: bool = True):
        if carry is None:
            return self.forward(x, self.init_stream(
                x.shape[0], x.shape[2], x.shape[3], x.dtype, x.device))[0]
        buffers, (pool_sum, count) = carry
        x = self.block1(x)
        new_buffers = []
        for block, buffer in zip(self.blocks(), buffers):
            x, buffer = block(x, buffer)
            new_buffers.append(buffer)
        x = self.conv(x)            # head conv, BN, hardswish, dropout
        # running mean over every frame seen: per-frame (H, W) means in f32
        pool_sum = pool_sum + x.float().mean(dim=(2, 3)).sum(dim=1)
        count = count + x.shape[1]
        y = (pool_sum / count).to(x.dtype)
        for layer in list(self.classifier)[2:]:    # after pool, flatten
            y = layer(y)
        return y, (tuple(new_buffers), (pool_sum, count))
