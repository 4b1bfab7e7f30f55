"""Plain blockwise 8-bit AdamW, written from its definition.

AdamW with decoupled weight decay (p -= lr * (m_hat / (sqrt(v_hat) + eps)
+ wd * p), bias-corrected moments). A tensor of at least ``min_8bit``
elements keeps both moments between steps as uint8 codes in blocks of
256 with one float32 scale per block (the block's absolute maximum, or
1 for an all-zero block); smaller tensors keep float32 moments.

The codebooks are tables of values, and a value is stored as the nearest
entry (a tie to the lower code):

* signed (the first moment): 0, and +-(1 + j/8) * 2**e for e in
  [-15, -1], j in [0, 7], and +-1: 243 codes;
* unsigned (the second moment): 0, and (1 + j/8) * 2**e for e in
  [-31, -1], and 1: 250 codes.

Only the values matter for the arithmetic. A stored code's number is
read in one place only, ``from_codes``: to follow a program from the
state it kept, whose code k is the k-th value of the sorted codebook.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 256
MIN_8BIT = 4096


def _magnitudes(octaves):
    vals = [(1 + j / 8) * 2.0 ** e for e in range(-octaves, 0)
            for j in range(8)]
    return vals + [1.0]


def codebook(signed: bool) -> torch.Tensor:
    """The sorted float64 values of a codebook."""
    mags = _magnitudes(15 if signed else 31)
    vals = [-m for m in reversed(mags)] + [0.0] + mags if signed \
        else [0.0] + mags
    return torch.tensor(vals, dtype=torch.float64)


def _nearest(a, table):
    """Each entry of ``a`` (float64) replaced by the nearest table value."""
    table = table.to(a.device)
    hi = torch.searchsorted(table, a.contiguous()).clamp(1, len(table) - 1)
    lo_v, hi_v = table[hi - 1], table[hi]
    return torch.where(a - lo_v <= hi_v - a, lo_v, hi_v)


def roundtrip(x, signed: bool):
    """x (float32) -> the float32 values its 8-bit blocks decode to."""
    flat = x.reshape(-1).double()
    pad = (-flat.numel()) % BLOCK
    blocks = torch.cat([flat, flat.new_zeros(pad)]).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(scale > 0, scale, torch.ones_like(scale)).float()
    # the block is scaled in float32, as the stored scale is float32
    a = (blocks.float() / scale).double()
    q = _nearest(a, codebook(signed)).float() * scale
    return q.reshape(-1)[:x.numel()].reshape(x.shape)


def from_codes(codes, scale, shape, signed: bool):
    """The float32 moment that uint8 ``codes`` (blocks, 256) with float32
    ``scale`` (blocks, 1) stand for: code k is the k-th sorted value of
    the codebook, times its block's scale."""
    table = codebook(signed).float().to(codes.device)
    vals = table[codes.long()] * scale.float()
    return vals.reshape(-1)[:int(np.prod(shape))].reshape(shape)


class AdamW8bit:
    def __init__(self, params, lr_of_step, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0, min_8bit=MIN_8BIT):
        self.params = list(params)
        self.lr_of_step = lr_of_step
        self.b1, self.b2 = betas
        self.eps, self.wd, self.min_8bit = eps, weight_decay, min_8bit
        self.t = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def load(self, t: int, m: list, v: list):
        """Continue from another's state: ``t`` steps taken, moments
        ``m`` and ``v`` (float32, one per parameter)."""
        self.t = int(t)
        self.m = [x.to(p.device, torch.float32).clone()
                  for x, p in zip(m, self.params)]
        self.v = [x.to(p.device, torch.float32).clone()
                  for x, p in zip(v, self.params)]

    @torch.no_grad()
    def step(self, grads):
        self.t += 1
        lr = self.lr_of_step(self.t)
        bc1, bc2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for i, (p, g) in enumerate(zip(self.params, grads)):
            g = torch.zeros_like(p) if g is None else g.float()
            m = self.b1 * self.m[i] + (1 - self.b1) * g
            v = self.b2 * self.v[i] + (1 - self.b2) * g * g
            p.copy_(p - lr * (m / bc1 / (torch.sqrt(v / bc2) + self.eps)
                              + self.wd * p))
            if p.numel() >= self.min_8bit:
                m, v = roundtrip(m, True), roundtrip(v, False)
            self.m[i], self.v[i] = m, v


def cosine_lr(base_lr, t_max, epoch, warmup=0):
    """torch's CosineAnnealingLR with eta_min = lr / 10, stepped per epoch,
    after an optional linear warmup, in float32 arithmetic."""
    f = np.float32
    e = f(epoch)
    if warmup > 0 and e < warmup:
        return float(f(base_lr) * (e + f(1.0)) / f(warmup))
    eta = base_lr / 10.0
    span = max(t_max - warmup, 1)
    return float(f(eta) + f((base_lr - eta) * 0.5) * (
        f(1.0) + np.cos(f(np.pi) * (e - f(warmup)) / f(span))))
