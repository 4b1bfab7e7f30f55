"""MobileNetLarge2D and MobileNetSmall2D: a per-frame 2-D CNN feeding an
LSTM, classifying from the last step. Channels-last.

Counterpart of ``picklebot_tpu/models/mobilenet2d_lstm.py`` (plain
forward), with the reference's module tree, so the state dicts have the
reference keys. The CNN runs once over every frame of the batch as
(B*T, H, W, C); the LSTM then runs over T (``ops.linear.LSTM``, the JAX
package's arithmetic). In train mode the BatchNorm statistics cover all
B*T frames at once, as in the JAX package.

Large: block1 = (Conv2d 3->16 k3 s2 with bias, BN, hardswish); block2-5 =
15 Bottleneck2D; block6 = (1x1 Conv2d 160->960 with bias, BN, hardswish,
AvgPool2d(7)); lstm = 5 layers of 32; classifier = (Linear 32->classes).
3,119,531 parameters at 13 classes. Small: the same stem; block2-3 = 11
Bottleneck2D; block4 = (1x1 Conv2d 96->576, SE, BN, hardswish,
AvgPool2d(7)); lstm = 1 layer of 64; classifier = (Linear 64->classes).
1,244,251 parameters at 13 classes. The reference's AvgPool2d(7) needs 7x7
maps: both take 224x224 frames.

Streaming: ``model(x, carry)`` runs x as the next chunk of a clip and
returns ``(logits, carry)``, the carry being the LSTM's per-layer (h, c)
from ``init_stream``; the LSTM is causal, so chunks give the whole clip's
logits. The model runs no hand-written kernel: its convs are matmuls and
cuDNN depthwise convs, as the JAX package leaves them to XLA. The JAX
package's fold options are not ported.
"""

from __future__ import annotations

import torch
from torch import nn

from picklebot_tpu_torch.ops import activations as act
from picklebot_tpu_torch.ops.bottleneck import Bottleneck2D
from picklebot_tpu_torch.ops.conv import Conv2d
from picklebot_tpu_torch.ops.linear import LSTM, AvgPool2d, Linear
from picklebot_tpu_torch.ops.norm import BatchNorm
from picklebot_tpu_torch.ops.se import SEBlock


def _conv_bn_act(cin, cout, kernel_size, stride=1, padding=0):
    return nn.Sequential(Conv2d(cin, cout, kernel_size, stride=stride,
                                padding=padding),
                         BatchNorm(cout), act.Activation(act.hardswish))


class _FrameLSTMNet(nn.Module):
    """What the two sizes share: seeded init, the batched frame CNN ->
    LSTM -> last-step classifier, and the stream carry."""

    def __init__(self, feature_dim: int, hidden: int, layers: int,
                 num_classes: int):
        super().__init__()
        self.num_classes = num_classes
        self.feature_dim = feature_dim
        self.lstm = LSTM(feature_dim, hidden, num_layers=layers)
        self.classifier = nn.Sequential(Linear(hidden, num_classes))

    def reset_parameters(self, seed: int):
        g = torch.Generator().manual_seed(seed)
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(g)

    def forward(self, x, carry=None, kernels: bool = True):
        """x (B, T, H, W, C) -> (B, num_classes) logits, or ``(logits,
        carry)`` when given a carry. ``kernels`` is accepted so that
        callers treat every model of the registry alike; this model runs
        no hand-written kernel."""
        b, t = x.shape[:2]
        feats = self.cnn(x.reshape((b * t,) + x.shape[2:]))
        feats = feats.reshape(b, t, self.feature_dim)
        if carry is None:
            return self.classifier(self.lstm(feats)[:, -1])
        seq, carry = self.lstm(feats, initial=carry, return_state=True)
        return self.classifier(seq[:, -1]), carry

    def cnn(self, frames):
        """(N, H, W, 3) frames -> (N, 1, 1, feature_dim)."""
        x = frames
        for stage in self.trunk():
            x = stage(x)
        return x

    def init_stream(self, batch: int, height: int = None, width: int = None,
                    dtype=torch.float32, device=None):
        """The zero LSTM state: (h, c), each (layers, batch, hidden). The
        frame size is taken, as ``MoViNetA2Stream.init_stream`` takes it,
        and not needed."""
        shape = (self.lstm.num_layers, batch, self.lstm.hidden_size)
        return (torch.zeros(shape, dtype=dtype, device=device),
                torch.zeros(shape, dtype=dtype, device=device))


class MobileNetLarge2D(_FrameLSTMNet):
    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__(feature_dim=960, hidden=32, layers=5,
                         num_classes=num_classes)
        B = Bottleneck2D
        relu = act.relu
        self.block1 = _conv_bn_act(3, 16, 3, stride=2, padding=1)
        self.block2 = nn.Sequential(
            B(16, 16, 16, stride=1, nonlinearity=relu),
            B(16, 24, 64, stride=2, nonlinearity=relu),
            B(24, 24, 72, stride=1, nonlinearity=relu),
        )
        self.block3 = nn.Sequential(
            B(24, 40, 72, stride=2, use_se=True, kernel_size=5,
              nonlinearity=relu),
            B(40, 40, 120, stride=1, use_se=True, kernel_size=5,
              nonlinearity=relu),
            B(40, 40, 120, stride=1, use_se=True, kernel_size=5,
              nonlinearity=relu),
        )
        self.block4 = nn.Sequential(
            B(40, 80, 240, stride=2),
            B(80, 80, 240, stride=1),
            B(80, 80, 184, stride=1),
            B(80, 80, 184, stride=1),
            B(80, 112, 480, stride=1, use_se=True),
            B(112, 112, 672, stride=1, use_se=True),
        )
        self.block5 = nn.Sequential(
            B(112, 160, 672, stride=2, use_se=True, kernel_size=5),
            B(160, 160, 960, stride=1, use_se=True, kernel_size=5),
            B(160, 160, 960, stride=1, use_se=True, kernel_size=5),
        )
        self.block6 = nn.Sequential(
            Conv2d(160, 960, 1), BatchNorm(960),
            act.Activation(act.hardswish), AvgPool2d(7, 1))
        self.reset_parameters(seed)

    def trunk(self):
        return (self.block1, self.block2, self.block3, self.block4,
                self.block5, self.block6)


class MobileNetSmall2D(_FrameLSTMNet):
    def __init__(self, num_classes: int = 2, seed: int = 0):
        super().__init__(feature_dim=576, hidden=64, layers=1,
                         num_classes=num_classes)
        B = Bottleneck2D
        relu = act.relu
        self.block1 = _conv_bn_act(3, 16, 3, stride=2, padding=1)
        self.block2 = nn.Sequential(
            B(16, 16, 16, stride=2, use_se=True, nonlinearity=relu),
            B(16, 24, 72, stride=2, nonlinearity=relu),
            B(24, 24, 88, stride=1, nonlinearity=relu),
        )
        self.block3 = nn.Sequential(
            B(24, 40, 96, stride=2, use_se=True, kernel_size=5),
            B(40, 40, 240, stride=1, use_se=True, kernel_size=5),
            B(40, 40, 240, stride=1, use_se=True, kernel_size=5),
            B(40, 48, 120, stride=1, use_se=True, kernel_size=5),
            B(48, 48, 144, stride=1, use_se=True, kernel_size=5),
            B(48, 96, 288, stride=2, use_se=True, kernel_size=5),
            B(96, 96, 576, stride=1, use_se=True, kernel_size=5),
            B(96, 96, 576, stride=1, use_se=True, kernel_size=5),
        )
        self.block4 = nn.Sequential(
            Conv2d(96, 576, 1), SEBlock(576, rank=4), BatchNorm(576),
            act.Activation(act.hardswish), AvgPool2d(7, 1))
        self.reset_parameters(seed)

    def trunk(self):
        return (self.block1, self.block2, self.block3, self.block4)
