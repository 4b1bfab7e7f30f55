"""Spatial resize inside the preprocessing of every train, eval and serve
step: native-resolution uint8 clips go to the device as they are and are
resampled there (``config.input_size``).

Counterpart of ``picklebot_tpu/ops/resize.py``, which calls
``jax.image.resize(method="bilinear", antialias=True)``. That function is
two weight-matrix contractions, one per spatial axis; this module keeps a
numpy copy of the matrix (``weight_matrix``, the formula of JAX's
``compute_weight_mat``: a triangle kernel widened by 1/scale on downscale,
each output column normalised, the samples outside [-0.5, n - 0.5]
zeroed) and contracts it with plain matmuls in the input's dtype, the
matrix cast to that dtype first. The axis whose contraction costs fewer
multiply-adds goes first, H on a tie, as the path of JAX's three-operand
einsum orders them; in bf16 the value between the two contractions is
rounded to bf16 there as here, so the two agree bit for bit where their
matrices do (they differ in the last f32 bit at some sizes).

Semantics are torchvision's ``Resize((s, s), antialias=True)``: bilinear,
antialiased on downscale, aspect ratio not kept. Linear in the pixels, so
it commutes with the mean/std standardization that follows it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """f32 (n_in, n_out): output sample j is sum_i x[i] * w[i, j]."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    sample = (np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(f32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _matrix(n_in: int, size: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(weight_matrix(n_in, size), dtype=like.dtype,
                        device=like.device)


def resize_frames(x: torch.Tensor, size: int) -> torch.Tensor:
    """(..., H, W, C) -> (..., size, size, C), in x's dtype; x itself when
    it is already size x size. Leading dims (accum, batch, time) pass
    through.

    One copy first puts C before W, (..., H, C, W): then the W contraction
    is one matmul over the rows of W, and the H contraction one matmul per
    leading index with the matrix broadcast over (C, W') columns. (With C
    = 3 innermost, either contraction would otherwise run as one tiny
    product per row of the batch.) An axis already at ``size`` is left
    alone, as JAX leaves it; of two, H first costs W*s*(H + s)
    multiply-adds per leading index and channel and W first H*s*(W + s),
    so W goes first exactly when W > H."""
    h, w, c = x.shape[-3:]
    size = int(size)
    if h == size and w == size:
        return x
    lead = x.shape[:-3]
    y = x.transpose(-1, -2).contiguous()                   # (..., H, C, W)
    axes = [a for a, n in (("h", h), ("w", w)) if n != size]
    if w > h:
        axes.reverse()
    for axis in axes:
        if axis == "w":
            y = torch.matmul(y, _matrix(w, size, y))       # (..., H', C, s)
        else:
            cols = y.shape[-2] * y.shape[-1]
            y = torch.matmul(_matrix(h, size, y).t(),
                             y.reshape(-1, h, cols))
            y = y.reshape(*lead, size, c, cols // c)       # (..., s, C, W')
    return y.transpose(-1, -2).contiguous()
