"""Dense and linear layers, global pooling and dropout.

Counterpart of ``picklebot_tpu/ops/linear.py``. ``Dense`` is the
reference's 1x1x1 Conv3d on a pooled (B, C) feature: it stores the
reference weight shape (O, I, 1, 1, 1) so state dicts load unchanged.
``Linear`` is the reference's nn.Linear, weight (O, I).

Dropout in train mode draws its masks from an explicit ``torch.Generator``
on the activation's device, the one of the innermost ``dropout_rng``
block, as the JAX package draws from the ``rng`` that ``apply(train=True)``
is given; a train-mode forward with dropout outside such a block raises.
The bits differ from the JAX package's (Philox against threefry); the
masks' shape, keep rate and inverted scaling are the same.
"""

from __future__ import annotations

import contextlib
import contextvars

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


_GENERATOR = contextvars.ContextVar("dropout_generator", default=None)


@contextlib.contextmanager
def dropout_rng(generator: torch.Generator):
    """Train-mode dropout inside this block (in this thread or task)
    draws from ``generator``."""
    token = _GENERATOR.set(generator)
    try:
        yield generator
    finally:
        _GENERATOR.reset(token)


def dropout_mask(shape, keep: float, device) -> torch.Tensor:
    """A bool mask of ``shape``, each entry True with probability
    ``keep``, from the current ``dropout_rng`` generator."""
    g = _GENERATOR.get()
    if g is None:
        raise ValueError("train-mode dropout needs a generator: run the "
                         "forward inside ops.linear.dropout_rng("
                         "torch.Generator(device))")
    device = torch.device(device)
    if g.device.type != device.type or (
            device.index or 0) != (g.device.index or 0):
        raise ValueError(f"dropout generator on {g.device}, activations "
                         f"on {device}")
    return torch.rand(shape, generator=g, device=device) < keep


def _drop(x, mask, keep):
    return torch.where(mask, x / keep, 0.0).to(x.dtype)


class ChannelDropout(nn.Module):
    """Dropout3d on channels-last activations: in train mode each sample
    loses whole channels, a (B, 1, ..., 1, C) mask, the rest scaled by
    1/keep; the identity in eval."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)
        return _drop(x, dropout_mask(shape, keep, x.device), keep)


class Dropout(nn.Module):
    """Elementwise dropout, inverted scaling: the identity in eval."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = p

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        return _drop(x, dropout_mask(x.shape, keep, x.device), keep)
