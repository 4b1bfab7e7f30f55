"""Dense and linear layers, pooling, dropout and the LSTM.

Counterpart of ``picklebot_tpu/ops/linear.py``. ``Dense`` is the
reference's 1x1 conv on a pooled (B, C) feature: it stores the reference
weight shape, (O, I, 1, 1, 1) for a Conv3d or (O, I, 1, 1) for a Conv2d
(``rank``), so state dicts load unchanged. ``Linear`` is the reference's
nn.Linear, weight (O, I). ``LSTM`` is nn.LSTM(batch_first) by its
parameter names, computed as the JAX package computes it (see its
docstring); ``AvgPool2d`` is nn.AvgPool2d on (B, H, W, C).

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
import math

import torch
import torch.nn.functional as F
from torch import nn

from picklebot_tpu_torch.ops.conv import torch_default_uniform_


class Dense(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, rank: int = 5):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = nn.Parameter(
            torch.empty((out_features, in_features) + (1,) * (rank - 2)))
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


class AvgPool2d(nn.Module):
    """nn.AvgPool2d(kernel_size, stride) on (B, H, W, C): the sum over each
    VALID window in f32 over k*k, cast back."""

    def __init__(self, kernel_size: int, stride=None):
        super().__init__()
        self.k = kernel_size
        self.s = kernel_size if stride is None else stride

    def forward(self, x):
        out = F.avg_pool2d(x.float().permute(0, 3, 1, 2), self.k, self.s)
        return out.permute(0, 2, 3, 1).to(x.dtype)


class LSTM(nn.Module):
    """Multi-layer unidirectional LSTM on (B, T, input_size), torch's
    nn.LSTM(batch_first) parameters per layer l: ``weight_ih_l{l}``
    (4H, in), ``weight_hh_l{l}`` (4H, H), ``bias_ih_l{l}``,
    ``bias_hh_l{l}`` (4H), gates in torch's order i, f, g, o.

    The arithmetic is the JAX package's, all in the input's (compute)
    dtype: one matmul projects every step's input and adds
    ``b_ih + b_hh`` (summed in f32, then cast); a loop over T adds
    ``h @ w_hh^T`` and updates (h, c), both carried in the compute dtype.
    nn.LSTM (cuDNN) keeps c in f32, so its bf16 result differs."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1):
        super().__init__()
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        h = hidden_size
        for l in range(num_layers):
            d = input_size if l == 0 else h
            self.register_parameter(f"weight_ih_l{l}",
                                    nn.Parameter(torch.empty(4 * h, d)))
            self.register_parameter(f"weight_hh_l{l}",
                                    nn.Parameter(torch.empty(4 * h, h)))
            self.register_parameter(f"bias_ih_l{l}",
                                    nn.Parameter(torch.empty(4 * h)))
            self.register_parameter(f"bias_hh_l{l}",
                                    nn.Parameter(torch.empty(4 * h)))

    def reset_parameters(self, generator: torch.Generator):
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.parameters():
                p.uniform_(-bound, bound, generator=generator)

    def forward(self, x, initial=None, return_state: bool = False):
        """x (B, T, input_size) -> the last layer's outputs (B, T, H).

        ``initial``: per-layer (h, c), each (num_layers, B, H), as
        nn.LSTM's (h_0, c_0); zeros without it. With ``return_state`` the
        final (h_T, c_T) stacks come back too: ``(seq, (h, c))``, the
        carry of a chunked (streaming) run."""
        dtype = x.dtype
        seq = x
        h_fin, c_fin = [], []
        for l in range(self.num_layers):
            w_ih = getattr(self, f"weight_ih_l{l}").to(dtype)
            w_hh = getattr(self, f"weight_hh_l{l}").to(dtype).t()
            bias = (getattr(self, f"bias_ih_l{l}")
                    + getattr(self, f"bias_hh_l{l}")).to(dtype)
            if initial is None:
                h = seq.new_zeros(seq.shape[0], self.hidden_size)
                c = torch.zeros_like(h)
            else:
                h, c = initial[0][l].to(dtype), initial[1][l].to(dtype)
            x_proj = F.linear(seq, w_ih) + bias
            outs = []
            for t in range(x_proj.shape[1]):
                gates = x_proj[:, t] + h @ w_hh
                i, f, g, o = gates.chunk(4, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
                outs.append(h)
            seq = torch.stack(outs, dim=1)
            h_fin.append(h)
            c_fin.append(c)
        if return_state:
            return seq, (torch.stack(h_fin), torch.stack(c_fin))
        return seq


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


def current_dropout_rng():
    """The generator of the innermost ``dropout_rng`` block, or None."""
    return _GENERATOR.get()


def keyed_stream(generator, *keys):
    """A ``dropout_rng`` block whose generator is seeded from one draw of
    ``generator`` and ``keys`` (ints): the port's counterpart of a JAX key
    folded with those keys (a rank, a layer, a microbatch). Every rank
    that holds the same ``generator`` state draws the same seed."""
    seed = int(torch.randint(2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return keyed_seed_stream(seed, *keys, device=generator.device)


def keyed_seed_stream(seed: int, *keys, device):
    """A ``dropout_rng`` block seeded from ``seed`` and ``keys``."""
    for k in keys:
        seed = (seed * 1_000_003 + int(k)) % 2 ** 63
    local = torch.Generator(device=device)
    local.manual_seed(seed)
    return dropout_rng(local)


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
