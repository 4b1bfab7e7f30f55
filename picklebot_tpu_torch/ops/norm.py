"""Normalization over the channel (last) axis of channels-last activations.

Counterpart of ``BatchNorm``, ``LayerNorm`` and ``GroupNorm`` in
``picklebot_tpu/ops/norm.py``, with the reference's torch parameter and
buffer names (weight, bias, running_mean, running_var,
num_batches_tracked). ``affine=False`` (MobileViT's conv_*_bn BatchNorms,
its attention's LayerNorm) has no weight or bias. BatchNorm's eval mode
folds (mean, var, weight, bias) into one per-channel multiply-add in f32
and applies it in the activation's dtype. Train mode follows torch, as
the JAX BatchNorm does: f32 batch statistics, the biased variance to
normalize and the unbiased one into ``running_var``, momentum 0.1,
``num_batches_tracked`` += 1; the buffers update without a graph (and
not in a remat recompute, ``core/remat.py``), the normalization is
differentiated through the batch statistics. The same
fold then applies them.
"""

from __future__ import annotations

import torch
from torch import nn

from picklebot_tpu_torch.core.remat import recomputing


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
            xf = x.float()
            dims = tuple(range(x.dim() - 1))
            mean = xf.mean(dims)
            var = xf.var(dims, unbiased=False)
            n = x.numel() // x.shape[-1]
            m = self.momentum
            # a remat recompute runs this forward again: the statistics
            # advance once, as in the JAX package
            if not recomputing():
                with torch.no_grad():
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(
                        m * (var * (n / max(n - 1, 1))))
                    self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        a = torch.rsqrt(var + self.eps)
        if self.affine:
            a = a * self.weight.float()
        b = -mean * a
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


class GroupNorm(nn.Module):
    """torch nn.GroupNorm on channels-last (B, *spatial, C): per sample,
    mean and biased variance over (spatial, C/G) in f32, the affine terms
    per channel, the result cast back to x's dtype. MobileViTV2 takes
    GroupNorm(1, C) as its pre- and post-attention norm."""

    def __init__(self, num_groups: int, num_channels: int,
                 eps: float = 1e-5, affine: bool = True):
        super().__init__()
        if num_channels % num_groups:
            raise ValueError(f"{num_channels} channels do not split into "
                             f"{num_groups} groups")
        self.num_groups = num_groups
        self.num_channels = num_channels
        self.eps = eps
        self.affine = affine
        if affine:
            self.weight = nn.Parameter(torch.ones(num_channels))
            self.bias = nn.Parameter(torch.zeros(num_channels))
        else:
            self.register_parameter("weight", None)
            self.register_parameter("bias", None)

    def reset_parameters(self, generator: torch.Generator):
        if self.affine:
            with torch.no_grad():
                self.weight.fill_(1.0)
                self.bias.zero_()

    def forward(self, x):
        g = self.num_groups
        xf = x.float()
        grouped = xf.reshape(x.shape[0], -1, g, self.num_channels // g)
        mean = grouped.mean(dim=(1, 3), keepdim=True)
        var = grouped.var(dim=(1, 3), unbiased=False, keepdim=True)
        out = ((grouped - mean) * torch.rsqrt(var + self.eps)).reshape(
            x.shape)
        if self.affine:
            out = out * self.weight.float() + self.bias.float()
        return out.to(x.dtype)
