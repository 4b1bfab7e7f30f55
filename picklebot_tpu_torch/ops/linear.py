"""Dense and linear layers, global pooling and dropout.

Counterpart of ``picklebot_tpu/ops/linear.py``. ``Dense`` is the
reference's 1x1x1 Conv3d on a pooled (B, C) feature: it stores the
reference weight shape (O, I, 1, 1, 1) so state dicts load unchanged.
``Linear`` is the reference's nn.Linear, weight (O, I).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops.conv import torch_default_uniform_


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, 1, 1, 1))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        torch_default_uniform_(self.weight, self.in_features, generator)
        if self.bias is not None:
            torch_default_uniform_(self.bias, self.in_features, generator)

    def matrix(self):
        """The weight as an (in, out) matrix."""
        return self.weight.view(self.out_features, self.in_features).t()

    def forward(self, x):
        out = x @ self.matrix().to(x.dtype)
        return out if self.bias is None else out + self.bias.to(x.dtype)


class Linear(nn.Module):
    """torch nn.Linear on (..., I): the weight in its (O, I) layout, cast
    with the bias to x's dtype."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if bias else None

    def reset_parameters(self, generator: torch.Generator):
        torch_default_uniform_(self.weight, self.in_features, generator)
        if self.bias is not None:
            torch_default_uniform_(self.bias, self.in_features, generator)

    def forward(self, x):
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class GlobalAvgPool(nn.Module):
    """Mean over every axis but batch and channel, reduced in f32 and cast
    back. Unmasked: padded frames count, as in the JAX package."""

    def forward(self, x):
        return x.float().mean(dim=tuple(range(1, x.dim() - 1))).to(x.dtype)


class ChannelDropout(nn.Module):
    """Dropout3d on channels-last activations: the identity in eval. Train
    mode (per-sample channel masks) comes with the training slice."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if self.training and self.p > 0.0:
            raise NotImplementedError(
                "ChannelDropout in train mode comes with the training slice "
                "of the port (ROADMAP.md, queue A, slice 2)")
        return x


class Dropout(nn.Module):
    """Elementwise dropout: the identity in eval. Train mode (masks) comes
    with the training slice."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if self.training and self.p > 0.0:
            raise NotImplementedError(
                "Dropout in train mode comes with the training slice of "
                "the port (ROADMAP.md, queue A, slice 2)")
        return x
