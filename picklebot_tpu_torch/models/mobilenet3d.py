"""MobileNetLarge3D and MobileNetSmall3D video classifiers, channels-last.

Counterpart of ``picklebot_tpu/models/mobilenet3d.py`` (plain forward), with
the reference's module tree, so the state dicts have the reference keys.
Large: block1 = (Conv3d 3->16 k3 s2, BN, hardswish); block2-5 = 15
Bottleneck3D; block6 = (1x1 Conv3d 160->960, BN, hardswish); classifier =
(global average pool, 1x1 conv 960->1280, hardswish, 1x1 conv
1280->classes). 4,205,675 parameters at 13 classes. Small: the same stem;
block2-3 = 11 Bottleneck3D (leaky relu in block2, SE on 9 of them);
block4 = (1x1 Conv3d 96->576, SE, BN, hardswish); classifier = (pool, 1x1
conv 576->1024, hardswish, 1x1 conv 1024->classes). 1,684,091 parameters
at 13 classes.

Input (B, T, H, W, 3) in the compute dtype (see ``train/step.preprocess``);
output (B, num_classes) logits in the same dtype. Weights are made from a
``torch.Generator`` seed with PyTorch's default conv init; BN starts at
identity statistics.
"""

from __future__ import annotations

import torch
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.bottleneck import Bottleneck3D
from picklebot_tpu_torch.ops.conv import Conv3d
from picklebot_tpu_torch.ops.linear import Dense, GlobalAvgPool
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.ops.se import SEBlock


def _conv_bn_act(cin, cout, kernel_size, stride=1, padding=0):
    return nn.Sequential(Conv3d(cin, cout, kernel_size, stride=stride,
                                padding=padding),
                         BatchNorm(cout), act.Activation(act.hardswish))


class _MobileNet3D(nn.Module):
    """What the two sizes share: seeded init, and a forward of stem ->
    bottlenecks -> head conv block -> classifier."""

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def forward(self, x, kernels: bool = True):
        """``kernels=False`` runs the plain bottleneck chain even on the
        card (the reference the kernels are held against)."""
        x = self.block1(x)
        for block in self.bottlenecks():
            x = block(x, kernels=kernels)
        return self.classifier(self.head(x))


class MobileNetLarge3D(_MobileNet3D):
    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        B = Bottleneck3D
        relu = act.relu
        self.block1 = _conv_bn_act(3, 16, 3, stride=2, padding=1)
        self.block2 = nn.Sequential(
            B(16, 16, 16, stride=1, nonlinearity=relu, dropout=0.2),
            B(16, 24, 64, stride=2, nonlinearity=relu, dropout=0.2),
            B(24, 24, 72, stride=1, nonlinearity=relu, dropout=0.2),
        )
        self.block3 = nn.Sequential(
            B(24, 40, 72, stride=2, use_se=True, kernel_size=5,
              nonlinearity=relu, dropout=0.2),
            B(40, 40, 120, stride=1, use_se=True, kernel_size=5,
              nonlinearity=relu, dropout=0.2),
            B(40, 40, 120, stride=1, use_se=True, kernel_size=5,
              nonlinearity=relu, dropout=0.2),
        )
        self.block4 = nn.Sequential(
            B(40, 80, 240, stride=2, dropout=0.2),
            B(80, 80, 240, stride=1, dropout=0.2),
            B(80, 80, 184, stride=1, dropout=0.2),
            B(80, 80, 184, stride=1, dropout=0.2),
            B(80, 112, 480, stride=1, use_se=True, dropout=0.2),
            B(112, 112, 672, stride=1, use_se=True, dropout=0.2),
        )
        self.block5 = nn.Sequential(
            B(112, 160, 672, stride=2, use_se=True, kernel_size=5,
              dropout=0.2),
            B(160, 160, 960, stride=1, use_se=True, kernel_size=5,
              dropout=0.2),
            B(160, 160, 960, stride=1, use_se=True, kernel_size=5,
              dropout=0.2),
        )
        self.block6 = _conv_bn_act(160, 960, 1)
        self.classifier = nn.Sequential(
            GlobalAvgPool(), Dense(960, 1280), act.Activation(act.hardswish),
            Dense(1280, num_classes))
        self.reset_parameters(seed)

    @property
    def head(self):
        return self.block6

    def bottlenecks(self):
        for stage in (self.block2, self.block3, self.block4, self.block5):
            yield from stage


class MobileNetSmall3D(_MobileNet3D):
    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__()
        self.num_classes = num_classes
        B = Bottleneck3D
        lrelu = act.leaky_relu
        self.block1 = _conv_bn_act(3, 16, 3, stride=2, padding=1)
        self.block2 = nn.Sequential(
            B(16, 16, 16, stride=2, use_se=True, nonlinearity=lrelu,
              dropout=0.2),
            B(16, 24, 72, stride=2, nonlinearity=lrelu, dropout=0.2),
            B(24, 24, 88, stride=1, nonlinearity=lrelu, dropout=0.2),
        )
        self.block3 = nn.Sequential(
            B(24, 40, 96, stride=2, use_se=True, kernel_size=5, dropout=0.2),
            B(40, 40, 240, stride=1, use_se=True, kernel_size=5, dropout=0.2),
            B(40, 40, 240, stride=1, use_se=True, kernel_size=5, dropout=0.2),
            B(40, 48, 120, stride=1, use_se=True, kernel_size=5, dropout=0.2),
            B(48, 48, 144, stride=1, use_se=True, kernel_size=5, dropout=0.2),
            B(48, 96, 288, stride=2, use_se=True, kernel_size=5, dropout=0.2),
            B(96, 96, 576, stride=1, use_se=True, kernel_size=5, dropout=0.2),
            B(96, 96, 576, stride=1, use_se=True, kernel_size=5, dropout=0.2),
        )
        # 1x1 conv -> SE -> BN -> hardswish, the reference's block4
        self.block4 = nn.Sequential(Conv3d(96, 576, 1), SEBlock(576),
                                    BatchNorm(576),
                                    act.Activation(act.hardswish))
        self.classifier = nn.Sequential(
            GlobalAvgPool(), Dense(576, 1024), act.Activation(act.hardswish),
            Dense(1024, num_classes))
        self.reset_parameters(seed)

    @property
    def head(self):
        return self.block4

    def bottlenecks(self):
        for stage in (self.block2, self.block3):
            yield from stage
