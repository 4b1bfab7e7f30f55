"""Seeded weights and inputs, made on the device in a few large calls.

One standard-normal draw covers every float entry of the reference
model's state dict, in its key order; each tensor then takes its share,
shaped by a rule read from the module that owns it and its shape:

* a convolution, matmul or embedding weight (2 or more dims): the
  configuration's ``init``, N(0, 2 / fan_in) (fan_in = the product of
  all dims but the first), N(0, 0.02**2), or PyTorch's default
  U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (the normal draw n taken to
  erf(n / sqrt 2), which is uniform on (-1, 1));
* the weight of a normalization module (``is_norm``) 1 + 0.1 N, its bias
  0.1 N; a BatchNorm's running mean 0.1 N and running variance
  exp(0.2 N), so that eval-mode BatchNorm is no identity
  (``calibrated`` sets the statistics a serving cell uses);
* any other float leaf 0.1 N; integer buffers zero.

The keys are the published model's, shared by the program and the plain
reference.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn.modules.batchnorm import _NormBase

VAR_FLOOR = 1e-2
NORM_KINDS = (_NormBase, nn.LayerNorm, nn.GroupNorm, nn.RMSNorm)


def is_norm(module) -> bool:
    """A normalization module: by its kind, or by ``is_normalization =
    True`` on its class (an RMSNorm written in a reference file)."""
    return isinstance(module, NORM_KINDS) or getattr(
        module, "is_normalization", False)


def _stream(seed: int, tag: int, device) -> torch.Generator:
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, tag])
    g = torch.Generator(device=device)
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]) % 2 ** 63)
    return g


def seeded_state(model, seed: int, device, init="he") -> dict:
    """{key: tensor} with the keys, shapes and dtypes of ``model``'s state
    dict (a reference model, on any device, ``meta`` too), drawn from
    ``seed`` on ``device``. ``init`` is the rule of the conv and matmul
    weights: ``"he"`` N(0, 2 / fan_in), ``"normal_0.02"`` N(0, 0.02**2)
    (MobileViT's published init), ``"torch_default"`` U(-1/sqrt(fan_in),
    1/sqrt(fan_in)) (PyTorch's default for a conv or linear layer)."""
    template = model.state_dict()
    floats = [(k, t) for k, t in template.items() if t.is_floating_point()]
    total = sum(t.numel() for _, t in floats)
    flat = torch.randn(total, generator=_stream(seed, 1, device),
                       device=device)
    out, at = {}, 0
    for k, t in floats:
        n = flat[at:at + t.numel()].view(t.shape)
        path, _, leaf = k.rpartition(".")
        owner = model.get_submodule(path)
        if t.dim() >= 2:
            fan_in = math.prod(t.shape[1:])
            if init == "he":
                v = n * math.sqrt(2.0 / fan_in)
            elif init == "normal_0.02":
                v = n * 0.02
            elif init == "torch_default":
                v = torch.erf(n / math.sqrt(2.0)) / math.sqrt(fan_in)
            else:
                raise ValueError(f"init {init!r}")
        elif is_norm(owner) and leaf == "weight":
            v = 1.0 + 0.1 * n
        elif isinstance(owner, _NormBase) and leaf == "running_var":
            v = torch.exp(0.2 * n)
        else:
            v = 0.1 * n
        at += t.numel()
        out[k] = v.to(t.dtype)
    for k, t in template.items():
        if k not in out:
            out[k] = torch.zeros(t.shape, dtype=t.dtype, device=device)
    return out


def seeded_clips(seed: int, tag: int, shape, device) -> np.ndarray:
    """uint8 clips of ``shape`` drawn on ``device``, returned on the host."""
    g = _stream(seed, tag, device)
    x = torch.randint(0, 256, tuple(shape), generator=g, device=device,
                      dtype=torch.uint8)
    return x.cpu().numpy()


def seeded_ints(seed: int, tag: int, high: int, shape) -> np.ndarray:
    rng = np.random.default_rng([int(seed) % 2 ** 64, tag])
    return rng.integers(0, high, size=shape).astype(np.int64)


def calibrated(state: dict, model, clips_u8, mean=None, std=None,
               var_floor=VAR_FLOOR) -> dict:
    """``state`` with every BatchNorm's running mean and variance set to
    the batch statistics of ``clips_u8`` (uint8 (N, T, H, W, 3)) through
    the plain reference ``model`` in float32, dropout off, the variances
    no lower than ``var_floor``: eval-mode BatchNorms then normalize as a
    trained model's do, and none divides a channel that barely varies by
    its rounding noise."""
    from portbench.reference.models import f32_exact
    from portbench.reference.steps import preprocess
    model.load_state_dict(state)
    drops = {}
    for m in model.modules():
        if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
            m.momentum = None
            m.reset_running_stats()
        if hasattr(m, "p"):
            drops[m], m.p = m.p, 0.0
    device = next(model.parameters()).device
    model.train()
    with torch.no_grad(), f32_exact():
        model(preprocess(torch.as_tensor(clips_u8).to(device), mean, std))
    for m, p in drops.items():
        m.p = p
    out = dict(state)
    for k, v in model.state_dict().items():
        if k.endswith(".running_mean"):
            out[k] = v.detach().clone()
        elif k.endswith(".running_var"):
            out[k] = v.detach().clamp(min=var_floor)
    return out
