"""BatchNorm over the channel (last) axis of channels-last activations.

Counterpart of ``BatchNorm`` in ``picklebot_tpu/ops/norm.py``, with the
reference's torch parameter and buffer names (weight, bias, running_mean,
running_var, num_batches_tracked). Eval mode folds (mean, var, weight,
bias) into one per-channel multiply-add in f32 and applies it in the
activation's dtype. Train-mode batch statistics belong to the training
slice (ROADMAP.md, queue A, slice 2).
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
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
        a = torch.rsqrt(self.running_var.float() + self.eps) * \
            self.weight.float()
        b = self.bias.float() - self.running_mean.float() * a
        return x * a.to(x.dtype) + b.to(x.dtype)
