"""Optimizers: AdamW and blockwise 8-bit AdamW, plus the cosine LR schedule.

Counterpart of ``picklebot_tpu/train/optim.py``, with the same semantics:

  * AdamW as torch defines it (decoupled weight decay p -= lr*wd*p,
    bias-corrected moments, eps outside the sqrt of the corrected second
    moment), written as the JAX package writes it, with the learning rate
    passed to every ``step`` (the schedule is data, not state). A
    parameter without a gradient steps with a zero one, as every JAX leaf
    has a gradient.
  * AdamW8bit: the same update, with both moments of every tensor of at
    least MIN_8BIT_SIZE elements stored as uint8 codes of the package's own
    dynamic (log-spaced minifloat) codebook with one f32 absmax scale per
    block of 256; encode and decode are frexp/exp2 arithmetic, bit-identical
    to the JAX side's ``xp=np`` path, with an exact code for 1.0 (each
    block's absmax round-trips losslessly). Smaller tensors keep f32
    moments.
  * ``cosine_annealing_lr``: torch CosineAnnealingLR with eta_min = lr/10,
    stepped per epoch, with an optional linear warmup, computed in f32 as
    the JAX schedule is.

The update runs on the parameters' device as a few elementwise torch ops
per tensor; it is not a kernel of the JAX package (XLA fuses it there).

Under ZeRO (``parallel/zero.py``) an optimizer is built on each rank's
flat (chunk,) slices of the parameters, as the JAX package inits on
(chunk,) prototypes: ``quantizes`` and the 256-blocks are then decided
per chunk. Its ``state_dict`` holds that rank's slices; the snapshot
stacks the ranks' into the JAX package's (n, chunk) layout
(``zero.gather_optimizer_state``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

BLOCK = 256
MIN_8BIT_SIZE = 4096
_SIGNED_ZERO = 121          # the signed codebook's 0.0
_SIGNED_OCTAVES, _UNSIGNED_OCTAVES = 15, 31


# --------------------------------------------------------------------------
# blockwise dynamic 8-bit <-> f32
# --------------------------------------------------------------------------

def _encode_mag(a, octaves: int):
    """Magnitudes in [0, 1] -> (code index 1.., is_zero): round to the
    nearest (1 + m/8) * 2^e, e in [-octaves, -1], with 1.0 its own top
    code."""
    mant, expo = torch.frexp(a)          # a = mant * 2^expo, mant in [.5, 1)
    m8 = torch.round(mant * 16.0 - 8.0)  # in [0, 8]
    rollover = m8 >= 8
    m8 = torch.where(rollover, 0.0, m8)
    e = expo - 1 + rollover.to(expo.dtype)
    overflow = e > -1
    emin = -octaves
    underflow = e < emin
    round_to_zero = a < 2.0 ** emin * 0.5
    k = (e.clamp(emin, -1) - emin) * 8 + m8
    k = torch.where(overflow, float(octaves * 8), k)
    k = torch.where(underflow, 0.0, k)
    return k.to(torch.int32) + 1, (a == 0) | (underflow & round_to_zero)


def _decode_mag(k, octaves: int):
    """code - 1 (k >= 0) -> magnitude."""
    e = torch.div(k, 8, rounding_mode="floor") - octaves
    return (1.0 + (k % 8).float() / 8.0) * torch.exp2(e.float())


def _blockify(x):
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK)
                                   ).reshape(-1, BLOCK)


def quantize_signed(x):
    """f32 -> (uint8 codes (blocks, 256), f32 absmax (blocks, 1)): codes
    0..120 the negatives (0 is -1.0), 121 zero, 122..242 the positives
    (242 is +1.0)."""
    xb = _blockify(x.float())
    absmax = xb.abs().amax(dim=1, keepdim=True)
    scale = torch.where(absmax > 0, absmax, 1.0)
    a = xb / scale
    code, is_zero = _encode_mag(a.abs(), _SIGNED_OCTAVES)
    idx = torch.where(a >= 0, _SIGNED_ZERO + code, _SIGNED_ZERO - code)
    idx = torch.where(is_zero, _SIGNED_ZERO, idx)
    return idx.to(torch.uint8), scale


def dequantize_signed(codes, scale, shape):
    c = codes.to(torch.int32) - _SIGNED_ZERO
    mag = _decode_mag(c.abs() - 1, _SIGNED_OCTAVES)
    val = torch.where(c == 0, 0.0, torch.sign(c).float() * mag)
    return (val * scale).reshape(-1)[:math.prod(shape)].reshape(shape)


def quantize_unsigned(x):
    """Non-negative f32 -> (uint8 codes, f32 block max): code 0 is zero,
    code 249 is 1.0."""
    xb = _blockify(x.float())
    vmax = xb.amax(dim=1, keepdim=True)
    scale = torch.where(vmax > 0, vmax, 1.0)
    code, is_zero = _encode_mag(xb / scale, _UNSIGNED_OCTAVES)
    return torch.where(is_zero, 0, code).to(torch.uint8), scale


def dequantize_unsigned(codes, scale, shape):
    c = codes.to(torch.int32)
    val = torch.where(c == 0, 0.0, _decode_mag(c - 1, _UNSIGNED_OCTAVES))
    return (val * scale).reshape(-1)[:math.prod(shape)].reshape(shape)


# --------------------------------------------------------------------------
# optimizers
# --------------------------------------------------------------------------

class AdamW:
    """AdamW over a list of f32 parameters; ``step(lr)`` after the
    gradients are in ``.grad``."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.params = [p for p in params if p.requires_grad]
        self.b1, self.b2 = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.steps = 0
        self.m = [self._init_moment(p, signed=True) for p in self.params]
        self.v = [self._init_moment(p, signed=False) for p in self.params]

    def quantizes(self, numel: int) -> bool:
        """Whether a tensor of ``numel`` elements keeps 8-bit moments."""
        return False

    def _init_moment(self, p, signed: bool):
        return torch.zeros_like(p, dtype=torch.float32)

    def _decode(self, p, m, v):
        return m, v

    def _encode(self, m, v, m_st, v_st):
        return m, v

    @torch.no_grad()
    def step(self, lr: float):
        self.steps += 1
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** self.steps
        bc2 = 1 - b2 ** self.steps
        for i, p in enumerate(self.params):
            g = (torch.zeros_like(p, dtype=torch.float32) if p.grad is None
                 else p.grad.float())
            m, v = self._decode(p, self.m[i], self.v[i])
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            denom = torch.sqrt(v / bc2) + self.eps
            p32 = p.float()
            p.copy_(p32 - lr * (m / bc1 / denom + self.weight_decay * p32))
            self.m[i], self.v[i] = self._encode(m, v, self.m[i], self.v[i])

    def state_dict(self) -> dict:
        """``steps`` and the moments of every parameter, in ``params``
        order, as CPU copies: an f32 tensor, or an 8-bit (codes, scales)
        pair. ``load_state_dict`` puts them back bit for bit."""
        def host(st):
            if isinstance(st, tuple):
                return tuple(t.detach().cpu().clone() for t in st)
            return st.detach().cpu().clone()
        return {"steps": self.steps, "m": [host(t) for t in self.m],
                "v": [host(t) for t in self.v],
                "shapes": [tuple(p.shape) for p in self.params]}

    def load_state_dict(self, state: dict):
        shapes = [tuple(p.shape) for p in self.params]
        if [tuple(s) for s in state["shapes"]] != shapes:
            raise ValueError(
                f"optimizer state for {len(state['shapes'])} parameters "
                f"does not fit these {len(shapes)} (a different model or "
                "freeze_params?)")

        def to(st, ref):
            if isinstance(ref, tuple) != isinstance(st, tuple):
                raise ValueError("optimizer state: 8-bit and f32 moments "
                                 "mixed up (another optimizer's state?)")
            if isinstance(st, tuple):
                return tuple(t.to(r.device) for t, r in zip(st, ref))
            return st.to(ref.device)
        self.m = [to(st, ref) for st, ref in zip(state["m"], self.m)]
        self.v = [to(st, ref) for st, ref in zip(state["v"], self.v)]
        self.steps = int(state["steps"])


class AdamW8bit(AdamW):
    """AdamW with 8-bit moments for tensors of at least ``min_8bit_size``
    elements (a (codes, scales) pair each); the arithmetic is AdamW's."""

    def __init__(self, params, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0,
                 min_8bit_size: int = MIN_8BIT_SIZE):
        self.min_8bit_size = min_8bit_size
        super().__init__(params, betas=betas, eps=eps,
                         weight_decay=weight_decay)

    def quantizes(self, numel: int) -> bool:
        return numel >= self.min_8bit_size

    def _init_moment(self, p, signed: bool):
        if not self.quantizes(p.numel()):
            return super()._init_moment(p, signed)
        blocks = -(-p.numel() // BLOCK)
        codes = torch.full((blocks, BLOCK), _SIGNED_ZERO if signed else 0,
                           dtype=torch.uint8, device=p.device)
        return codes, torch.ones((blocks, 1), device=p.device)

    def _decode(self, p, m, v):
        if isinstance(m, tuple):
            return (dequantize_signed(*m, p.shape),
                    dequantize_unsigned(*v, p.shape))
        return m, v

    def _encode(self, m, v, m_st, v_st):
        if isinstance(m_st, tuple):
            return quantize_signed(m), quantize_unsigned(v)
        return m, v


OPTIMIZERS = {"adamw": AdamW, "adamw8bit": AdamW8bit}


def cosine_annealing_lr(base_lr: float, t_max: int,
                        eta_min: Optional[float] = None,
                        warmup: int = 0) -> Callable[[int], float]:
    """epoch -> lr: eta + (lr - eta) * (1 + cos(pi * (e - warmup) /
    (t_max - warmup))) / 2, eta = lr/10 by default; for e < warmup the
    ramp lr * (e + 1) / warmup. In f32, in the JAX schedule's order."""
    eta = base_lr / 10.0 if eta_min is None else eta_min
    span = max(t_max - warmup, 1)
    f = np.float32

    def schedule(epoch: int) -> float:
        e = f(epoch)
        cos = f(eta) + f((base_lr - eta) * 0.5) * (
            f(1.0) + np.cos(f(np.pi) * (e - f(warmup)) / f(span)))
        if warmup > 0 and e < warmup:
            return float(f(base_lr) * (e + f(1.0)) / f(warmup))
        return float(cos)

    return schedule
