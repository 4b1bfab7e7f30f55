"""Ring attention: exact softmax attention over a sequence sharded across
a mesh axis.

Counterpart of ``picklebot_tpu/ops/ring_attention.py``. Each rank of the
axis holds an equal token block of Q, K and V; the K/V blocks travel
around the ring (``parallel/mesh.py`` ``ppermute``: to the next rank,
from the previous one) and every rank folds each visiting block into its
queries' attention with the online-softmax recurrence (running max,
denominator and numerator in f32), so the result is full softmax
attention while no rank holds the (N, N) scores or the whole K/V. The
resident block comes first, then size - 1 rotations: no final hop
returns the blocks to where they started.

The rotation is a ``torch.autograd.Function`` whose backward is the
inverse permutation, so autograd over the loop gives the counter-rotating
ring of the dK/dV gradients, as JAX's transpose of ``ppermute`` does.
Each hop moves K and V in one batch of sends and receives; each counts as
one collective-permute of its bytes, as the JAX step's two ``ppermute``
ops do.

This is plain PyTorch, not a kernel: the JAX function is einsums outside
any Pallas kernel, so it is no row of the kernel table, and no fused
attention stands in for it, because the recurrence over the visiting
blocks is the function. At an axis of size 1 it is ``sdpa``.
"""

from __future__ import annotations

from typing import Optional

import torch

from picklebot_tpu_torch.ops.flash_attention import sdpa
from picklebot_tpu_torch.parallel import mesh


class _Rotate(torch.autograd.Function):
    """(k, v) -> the previous rank's (k, v); backward sends the gradients
    the other way round."""

    @staticmethod
    def forward(ctx, k, v, axis):
        ctx.axis = axis
        return tuple(mesh.ppermute([k, v], axis, shift=1))

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = mesh.ppermute([gk, gv], ctx.axis, shift=-1)
        return gk, gv, None


def rotate(k: torch.Tensor, v: torch.Tensor, axis: str):
    """One hop of the ring: this rank's K/V blocks go to the next rank of
    ``axis`` and the previous rank's arrive."""
    return _Rotate.apply(k, v, axis)


def ring_attention(q, k, v, axis: str = "seq",
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention with Q/K/V token-sharded over ``axis``: q, k, v
    (..., n_local, d), the same n_local on every rank. Returns
    (..., n_local, d) in q's dtype: rank r's rows are rows [r * n_local,
    (r + 1) * n_local) of attention over the whole sequence. Scores and
    the recurrence are f32; P.V takes P rounded to v's dtype, accumulated
    in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    size = mesh.axis_size(axis)
    if size == 1:
        return sdpa(q, k, v, scale).to(q.dtype)
    q32 = q.float()

    def accumulate(k_cur, v_cur, m, l, acc):
        s = torch.matmul(q32, k_cur.float().transpose(-1, -2)) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)       # exp(-inf - finite) = 0 at first
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.matmul(p.to(v_cur.dtype).float(),
                                        v_cur.float())
        return m_new, l, acc

    shape = q.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(q.shape[:-1] + (v.shape[-1],), device=q.device)
    m, l, acc = accumulate(k, v, m, l, acc)
    k_cur, v_cur = k, v
    for _ in range(size - 1):
        k_cur, v_cur = rotate(k_cur, v_cur, axis)
        m, l, acc = accumulate(k_cur, v_cur, m, l, acc)
    return (acc / l).to(q.dtype)
