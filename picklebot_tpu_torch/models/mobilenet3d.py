"""MobileNetLarge3D video classifier, channels-last.

Counterpart of ``picklebot_tpu/models/mobilenet3d.py`` (plain forward), with
the reference's module tree, so its state dict has the reference keys:
block1 = (Conv3d 3->16 k3 s2, BN, hardswish); block2-5 = 15 Bottleneck3D;
block6 = (1x1 Conv3d 160->960, BN, hardswish); classifier = (global average
pool, 1x1 conv 960->1280, hardswish, 1x1 conv 1280->classes). 4,205,675
parameters at 13 classes.

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


def _conv_bn_act(cin, cout, kernel_size, stride=1, padding=0):
    return nn.Sequential(Conv3d(cin, cout, kernel_size, stride=stride,
                                padding=padding),
                         BatchNorm(cout), act.Activation(act.hardswish))


class MobileNetLarge3D(nn.Module):
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

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def bottlenecks(self):
        for stage in (self.block2, self.block3, self.block4, self.block5):
            yield from stage

    def forward(self, x, kernels: bool = True):
        """``kernels=False`` runs the plain bottleneck chain even on the
        card (the reference the kernels are held against)."""
        x = self.block1(x)
        for block in self.bottlenecks():
            x = block(x, kernels=kernels)
        return self.classifier(self.block6(x))
