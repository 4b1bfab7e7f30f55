"""Elementwise activations with PyTorch's semantics, relu6-based as in
``picklebot_tpu/ops/activations.py``; ``silu`` for MobileViT."""

import torch
from torch import nn


def relu(x):
    return torch.clamp_min(x, 0)


def relu6(x):
    return torch.clamp(x, 0, 6)


def hardsigmoid(x):
    # nn.Hardsigmoid: relu6(x + 3) / 6
    return relu6(x + 3.0) * (1.0 / 6.0)


def hardswish(x):
    # nn.Hardswish: x * relu6(x + 3) / 6
    return x * (relu6(x + 3.0) * (1.0 / 6.0))


def silu(x):
    # x * sigmoid(x), as the JAX package writes it (not the fused F.silu,
    # which rounds once where this rounds twice in bf16)
    return x * torch.sigmoid(x)


def identity(x):
    return x


class Activation(nn.Module):
    """A parameter-free activation as a module, so that Sequential indices
    (and with them state-dict keys) line up with the reference's."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)
