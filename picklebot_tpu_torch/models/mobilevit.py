"""MobileViT (v1) video classifier, channels-last.

Counterpart of ``picklebot_tpu/models/mobilevit.py`` (plain forward), with
the reference's module tree, so its state dict has the reference keys:
conv1 = conv_nxn_bn(3, ch[0], stride 2); stem = 4 Bottleneck3D; trunk = 3
stages of Sequential(Bottleneck3D stride 2, MobileViTBlock); to_logits =
(conv_1x1_bn, global average pool, bias-free Linear). Each MobileViTBlock
pads (T, H, W) to multiples of the (2, 2, 2) patch, regroups the tokens
into 8 patch-position sequences of t*h*w tokens (a reshape and permute),
runs a pre-LN transformer (8 heads of 16), folds back, crops, concatenates
the block input and fuses with conv4.

The reference's quirks are kept: conv_nxn_bn pads by 1 whatever its
kernel size, its BatchNorm has no affine terms, the FeedForward has no
pre-norm, trunk[1]'s expansion is ``ch[7] * expansion`` and trunk[2]'s a
literal ``* 4``. Parameters: xxs 2,030,368 / xs 3,483,984 / s 8,453,136.

Input (B, T, H, W, 3) in the compute dtype; output (B, num_classes) logits
in the same dtype. Every conv and linear weight is drawn from N(0, 0.02^2)
with a ``torch.Generator`` seed and every bias is zero, as the reference
initializes; BatchNorm starts at identity statistics. The bottlenecks run
the fused kernels of ``ops/fused_bottleneck.py`` on the card and the
attention the flash kernels of ``ops/flash_attention.py``; the dense
3x3x3 convs, the 1x1 convs and the linears are cuDNN and matmul calls, as
the JAX package leaves them to XLA.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.attention import MultiHeadAttention
from picklebot_tpu_torch.ops.bottleneck import Bottleneck3D
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import Dropout, GlobalAvgPool, Linear
from picklebot_tpu_torch.ops.norm import BatchNorm

_INIT_STD = 0.02


def _conv_bn_silu(cin, cout, kernel_size, stride, padding):
    return nn.Sequential(
        Conv3d(cin, cout, kernel_size, stride=stride, padding=padding,
               bias=False),
        BatchNorm(cout, affine=False), act.Activation(act.silu))


def conv_1x1_bn(cin, cout):
    return _conv_bn_silu(cin, cout, 1, 1, 0)


def conv_nxn_bn(cin, cout, kernel_size=3, stride=1):
    return _conv_bn_silu(cin, cout, kernel_size, stride, 1)


class FeedForward(nn.Module):
    """Linear -> SiLU -> Dropout -> Linear -> Dropout, bias-free, with no
    pre-norm (the reference's)."""

    def __init__(self, embed_dim, hidden_dim, dropout=0.0):
        super().__init__()
        self.net = nn.Sequential(
            Linear(embed_dim, hidden_dim, bias=False),
            act.Activation(act.silu), Dropout(dropout),
            Linear(hidden_dim, embed_dim, bias=False), Dropout(dropout))

    def forward(self, x):
        return self.net(x)


class TransformerStack(nn.Module):
    """depth x (pre-LN attention + residual, FeedForward + residual): the
    plain layer loop. Its sequence- and pipeline-parallel forms belong to
    the parallel layouts slice (ROADMAP.md, queue A, slice 7)."""

    def __init__(self, embed_dim, depth, heads, dim_head, ffw_dim,
                 dropout=0.0, backend="auto"):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                MultiHeadAttention(embed_dim, heads, dim_head, dropout,
                                   backend=backend),
                FeedForward(embed_dim, ffw_dim, dropout)])
            for _ in range(depth)])

    def forward(self, x, kernels: bool = True):
        for attn, ff in self.layers:
            x = attn(x, kernels=kernels) + x
            x = ff(x) + x
        return x


class MobileViTBlock(nn.Module):
    def __init__(self, embed_dim, depth, channel, kernel_size=3,
                 patch_size=(2, 2, 2), ffw_dim=None, dropout=0.0,
                 backend="auto"):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.conv1 = conv_nxn_bn(channel, channel, kernel_size)
        self.conv2 = conv_1x1_bn(channel, embed_dim)
        self.transformer = TransformerStack(embed_dim, depth, 8, 16, ffw_dim,
                                            dropout, backend)
        self.conv3 = conv_1x1_bn(embed_dim, channel)
        self.conv4 = conv_nxn_bn(2 * channel, channel, kernel_size)

    def forward(self, x, kernels: bool = True):
        y = x
        x = self.conv2(self.conv1(x))
        b, t, h, w, d = x.shape
        pt, ph, pw = self.patch_size
        tp, hp, wp = -(-t // pt), -(-h // ph), -(-w // pw)
        x = F.pad(x, (0, 0, 0, wp * pw - w, 0, hp * ph - h, 0, tp * pt - t))
        # unfold: (B, T, H, W, D) -> (B, pt*ph*pw, t*h*w, D)
        x = x.reshape(b, tp, pt, hp, ph, wp, pw, d)
        x = x.permute(0, 2, 4, 6, 1, 3, 5, 7).reshape(b, pt * ph * pw,
                                                      tp * hp * wp, d)
        x = self.transformer(x, kernels=kernels)
        # fold back and crop the padding
        x = x.reshape(b, pt, ph, pw, tp, hp, wp, d)
        x = x.permute(0, 4, 1, 5, 2, 6, 3, 7).reshape(b, tp * pt, hp * ph,
                                                      wp * pw, d)
        x = self.conv3(x[:, :t, :h, :w, :])
        return self.conv4(torch.cat([x, y.to(x.dtype)], dim=-1))


class MobileViT(nn.Module):
    def __init__(self, dims: Sequence[int], channels: Sequence[int],
                 num_classes: int, expansion: int = 4,
                 kernel_size: int = 3,
                 patch_size: Tuple[int, int, int] = (2, 2, 2),
                 depths: Tuple[int, int, int] = (2, 4, 3),
                 attention_backend: str = "auto", seed: int = 0):
        super().__init__()
        assert len(dims) == 3 and len(depths) == 3
        ch = list(channels)
        self.num_classes = num_classes
        B = Bottleneck3D
        self.conv1 = conv_nxn_bn(3, ch[0], stride=2)
        self.stem = nn.ModuleList([
            B(ch[0], ch[1], ch[0] * expansion, stride=1),
            B(ch[1], ch[2], ch[1] * expansion, stride=2),
            B(ch[2], ch[3], ch[2] * expansion, stride=1),
            B(ch[2], ch[3], ch[2] * expansion, stride=1),
        ])

        def vit(i, ffw_mult, channel):
            return MobileViTBlock(dims[i], depths[i], channel, kernel_size,
                                  patch_size, int(dims[i] * ffw_mult),
                                  backend=attention_backend)

        self.trunk = nn.ModuleList([
            nn.Sequential(B(ch[3], ch[4], ch[3] * expansion, stride=2),
                          vit(0, 2, ch[5])),
            # reference quirk: the expansion comes from ch[7], the next
            # stage's width, not from this block's ch[5]
            nn.Sequential(B(ch[5], ch[6], ch[7] * expansion, stride=2),
                          vit(1, 4, ch[7])),
            # reference quirk: a literal 4, not the expansion
            nn.Sequential(B(ch[7], ch[8], ch[7] * 4, stride=2),
                          vit(2, 4, ch[9])),
        ])
        self.to_logits = nn.Sequential(
            conv_1x1_bn(ch[-2], ch[-1]), GlobalAvgPool(),
            Linear(ch[-1], num_classes, bias=False))
        self.reset_parameters(seed)

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if isinstance(m, (Conv3d, Linear)):
                with torch.no_grad():
                    m.weight.normal_(0.0, _INIT_STD, generator=g)
                    if m.bias is not None:
                        m.bias.zero_()
            elif m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def bottlenecks(self):
        yield from self.stem
        for stage in self.trunk:
            yield stage[0]

    def forward(self, x, kernels: bool = True):
        """``kernels=False`` runs the plain bottleneck chain and ``sdpa``
        even on the card (the reference the kernels are held against)."""
        x = self.conv1(x)
        for block in self.stem:
            x = block(x, kernels=kernels)
        for bottleneck, vit_block in self.trunk:
            x = vit_block(bottleneck(x, kernels=kernels), kernels=kernels)
        return self.to_logits(x)


# the reference's config/mobilevit_{xxs,xs,s}.json
MOBILEVIT_CONFIGS = {
    "xxs": dict(dims=[64, 80, 96],
                channels=[16, 16, 24, 24, 48, 48, 64, 64, 80, 80, 320]),
    "xs": dict(dims=[96, 120, 144],
               channels=[16, 32, 48, 48, 64, 64, 80, 80, 96, 96, 384]),
    "s": dict(dims=[144, 192, 240],
              channels=[16, 32, 64, 64, 96, 96, 128, 128, 160, 160, 640]),
}
