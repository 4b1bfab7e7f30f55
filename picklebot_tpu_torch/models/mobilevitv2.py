"""MobileViTV2, the image classifier: separable linear attention on 2-D
images, channels-last.

Counterpart of ``picklebot_tpu/models/mobilevitv2.py`` (plain forward),
with the reference's module tree, so its state dict has the reference
keys (each transformer's layer list is ``transformer.layer.N``): conv1 =
3x3 stride-2 Conv2d 3->32; bn1-bn3_5 = four Bottleneck2D; transformer1-3
= MobileViTV2Layer (a stride-2 Bottleneck2D, ``convkxk``, ``conv1x1``, a
2x2 unfold into (B, 4, N, C), 2 / 4 / 3 transformer layers of GroupNorm ->
LinearSelfAttention -> residual, GroupNorm -> FFN -> residual, a
GroupNorm, the fold, ``conv_projection``); a global average pool and a
Linear 512 -> classes. 9,223,185 parameters at 1000 classes.

The reference's quirks are kept, since they change shapes: its "1x1"
convs ``conv1x1`` and ``conv_projection`` carry ``padding=1`` and grow H
and W by 2 each; ``convkxk`` is dense (groups=1) despite its "depthwise"
comment. The unfold crops an odd H or W to even, and the fold pads the
crop back with zeros, as torch's F.unfold / F.fold do in the reference.

Input (B, H, W, 3) in the compute dtype; output (B, num_classes) logits in
the same dtype. Every conv and dense weight is drawn from N(0, 0.02^2)
with a ``torch.Generator`` seed and every bias is zero; GroupNorm and
BatchNorm start at weight 1, bias 0 and identity statistics. The model
runs no hand-written kernel: its 2-D bottlenecks are the plain chain, as
in the JAX package, and the linear attention has no kernel there either.
The JAX package's ``space_to_depth`` stem is not ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.attention import LinearSelfAttention
from picklebot_tpu_torch.ops.bottleneck import Bottleneck2D
from picklebot_tpu_torch.ops.conv import Conv2d
from picklebot_tpu_torch.ops.linear import (Dense, Dropout, GlobalAvgPool,
                                            Linear)
from picklebot_tpu_torch.ops.norm import GroupNorm

_INIT_STD = 0.02


class MobileViTV2FFN(nn.Module):
    """1x1 conv -> SiLU -> dropout -> 1x1 conv -> dropout over C; the
    convs are dense layers on (B, P, N, C) with the reference's
    (O, I, 1, 1) weights."""

    def __init__(self, embed_dim: int, ffn_latent_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.conv1 = Dense(embed_dim, ffn_latent_dim, rank=4)
        self.dropout1 = Dropout(dropout)
        self.conv2 = Dense(ffn_latent_dim, embed_dim, rank=4)
        self.dropout2 = Dropout(dropout)

    def forward(self, x):
        x = self.dropout1(act.silu(self.conv1(x)))
        return self.dropout2(self.conv2(x))


class MobileViTV2TransformerLayer(nn.Module):
    def __init__(self, embed_dim: int, ffn_latent_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.layernorm_before = GroupNorm(1, embed_dim)
        self.attention = LinearSelfAttention(embed_dim, dropout)
        self.dropout = Dropout(dropout)
        self.layernorm_after = GroupNorm(1, embed_dim)
        self.ffn = MobileViTV2FFN(embed_dim, ffn_latent_dim, dropout)

    def forward(self, x):
        x = self.dropout(self.attention(self.layernorm_before(x))) + x
        return self.ffn(self.layernorm_after(x)) + x


class MobileViTV2Transformer(nn.Module):
    """The layer list under the reference's key ``transformer.layer``."""

    def __init__(self, embed_dim: int, ffn_latent_dim: int, depth: int):
        super().__init__()
        self.layer = nn.ModuleList([
            MobileViTV2TransformerLayer(embed_dim, ffn_latent_dim)
            for _ in range(depth)])

    def forward(self, x):
        for layer in self.layer:
            x = layer(x)
        return x


class MobileViTV2Layer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 attn_unit_dim: int, kernel_size: int = 3,
                 patch_size: int = 2, n_attn_blocks: int = 2,
                 expansion_ratio: int = 2, stride: int = 2):
        super().__init__()
        self.patch = patch_size
        if stride == 2:
            self.downsampling_layer = Bottleneck2D(
                in_channels, out_channels,
                expanded_channels=in_channels * expansion_ratio,
                stride=stride, kernel_size=kernel_size)
            in_channels = out_channels
        else:
            self.downsampling_layer = None
        self.convkxk = Conv2d(in_channels, in_channels, kernel_size,
                              padding=1, bias=False)
        # the reference's padding=1 on a 1x1 conv: H and W grow by 2
        self.conv1x1 = Conv2d(in_channels, attn_unit_dim, 1, padding=1,
                              bias=False)
        self.transformer = MobileViTV2Transformer(
            attn_unit_dim, (2 * attn_unit_dim // 16) * 16, n_attn_blocks)
        self.layernorm = GroupNorm(1, attn_unit_dim)
        self.conv_projection = Conv2d(attn_unit_dim, in_channels, 1,
                                      padding=1, bias=False)

    def forward(self, x):
        if self.downsampling_layer is not None:
            x = self.downsampling_layer(x)
        x = self.conv1x1(self.convkxk(x))
        b, big_h, big_w, c = x.shape
        p = self.patch
        h, w = big_h // p, big_w // p
        # unfold: (B, h*p, w*p, C) -> (B, p*p, h*w, C), an odd H or W
        # cropped first
        x = x[:, :h * p, :w * p].reshape(b, h, p, w, p, c)
        x = x.permute(0, 2, 4, 1, 3, 5).reshape(b, p * p, h * w, c)
        x = self.layernorm(self.transformer(x))
        # fold back, the cropped rows and columns as zeros
        x = x.reshape(b, p, p, h, w, c).permute(0, 3, 1, 4, 2, 5)
        x = F.pad(x.reshape(b, h * p, w * p, c),
                  (0, 0, 0, big_w - w * p, 0, big_h - h * p))
        return self.conv_projection(x)


class MobileViTV2(nn.Module):
    def __init__(self, expand_ratio: int = 2, num_classes: int = 1000,
                 seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        B = Bottleneck2D
        self.conv1 = Conv2d(3, 32, 3, stride=2, padding=1, bias=False)
        self.bn1 = B(32, 64, expanded_channels=32 * expand_ratio)
        self.bn2 = B(64, 128, expanded_channels=64 * expand_ratio, stride=2)
        self.bn3 = B(128, 128, expanded_channels=128 * expand_ratio)
        self.bn3_5 = B(128, 128, expanded_channels=128 * expand_ratio)
        self.transformer1 = MobileViTV2Layer(128, 256, 128, n_attn_blocks=2)
        self.transformer2 = MobileViTV2Layer(256, 384, 192, n_attn_blocks=4)
        self.transformer3 = MobileViTV2Layer(384, 512, 256, n_attn_blocks=3)
        self.pool = GlobalAvgPool()
        self.fc = Linear(512, num_classes)
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv2d, Dense, Linear)):
                with torch.no_grad():
                    m.weight.normal_(0.0, _INIT_STD, generator=g)
                    if m.bias is not None:
                        m.bias.zero_()
            elif m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def forward(self, x, kernels: bool = True):
        """x (B, H, W, 3) -> (B, num_classes) logits. ``kernels`` is
        accepted so that callers treat every model of the registry alike;
        this model runs no hand-written kernel."""
        x = self.conv1(x)
        for block in (self.bn1, self.bn2, self.bn3, self.bn3_5,
                      self.transformer1, self.transformer2,
                      self.transformer3):
            x = block(x)
        return self.fc(self.pool(x))
