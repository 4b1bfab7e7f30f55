"""Normalization over the channel (last) axis of channels-last activations.

Counterpart of ``BatchNorm`` and ``LayerNorm`` in
``picklebot_tpu/ops/norm.py``, with the reference's torch parameter and
buffer names (weight, bias, running_mean, running_var,
num_batches_tracked). ``affine=False`` (MobileViT's conv_*_bn BatchNorms,
its attention's LayerNorm) has no weight or bias. BatchNorm's eval mode
folds (mean, var, weight, bias) into one per-channel multiply-add in f32
and applies it in the activation's dtype. Train-mode batch statistics
belong to the training slice (ROADMAP.md, queue A, slice 2).
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            if self.affine:
                self.weight.fill_(1.0)
                self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)
            self.num_batches_tracked.zero_()

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "BatchNorm train-mode statistics come with the training "
                "slice of the port (ROADMAP.md, queue A, slice 2); call "
                "model.eval() to serve")
        a = torch.rsqrt(self.running_var.float() + self.eps)
        if self.affine:
            a = a * self.weight.float()
        b = -self.running_mean.float() * a
        if self.affine:
            b = b + self.bias.float()
        return x * a.to(x.dtype) + b.to(x.dtype)


class LayerNorm(nn.Module):
    """torch nn.LayerNorm over the last axis: statistics and the
    normalization in f32, the result cast back to x's dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, unbiased=False, keepdim=True)
        out = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            out = out * self.weight.float() + self.bias.float()
        return out.to(x.dtype)
