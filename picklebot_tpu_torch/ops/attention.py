"""Multi-head attention as MobileViT uses it, and MobileViTV2's separable
linear attention.

Counterpart of ``MultiHeadAttention`` and ``sdpa_xla`` in
``picklebot_tpu/ops/attention.py``, with the reference's module tree (so
the state dict has the reference keys ``to_qkv.weight`` and
``to_out.0.weight``): pre-LN without affine, a fused bias-free qkv
projection, H heads of D, scaled dot-product attention, the head merge
(the JAX package's documented divergence from the reference), and a
bias-free output projection.

Backends, dispatched as in the JAX package:
  auto           the head-packed kernel when every head fits (H*D <= 128)
                 and N >= _PACKED_MIN_SEQ, else ``sdpa``
  xla            ``sdpa`` (plain matmul and softmax)
  packed         the head-packed kernel (``flash_attention_packed``)
  pallas         the per-head kernel (``flash_attention``) on split heads
  pallas_packed  the per-head kernel on the (..., N, 3, H, D) qkv layout
                 (``flash_attention_qkvpacked``)
The kernels are those of ``ops/flash_attention.py``; on a CPU tensor they
run their plain versions, and in training their autograd Functions (the
backward kernels). ``forward(x, kernels=False)`` runs ``sdpa`` whatever
the backend, on the card too: the reference the kernels are held against.
In train mode with dropout > 0 every backend runs ``sdpa`` with
attention-probability dropout, as the JAX package falls back to XLA there
(the kernels have no dropout path).

Sequence parallelism (``sequence_axis``; the JAX ``_forward_sp``): with
``sp_active`` the input is this rank's token block of a sequence that the
``TransformerStack`` scattered over the axis. Without dropout the
attention is ``ring_attention`` over the axis (plain PyTorch, the K/V
blocks travel round the ring); with attention dropout in train mode the
K/V blocks are all-gathered and the local queries run ``sdpa`` with the
mask drawn per rank (the stack seeds the dropout stream with the rank).

``LinearSelfAttention`` is the counterpart of the JAX package's: a
softmax over patches, a sum and a gated product, which no TPU kernel
computes there either, so it runs plain PyTorch ops on every device.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from picklebot_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_packed, flash_attention_qkvpacked,
    merge_heads, sdpa, split_heads)
from picklebot_tpu_torch.ops.linear import Dense, Dropout, Linear
from picklebot_tpu_torch.ops.norm import LayerNorm

# 'auto' sends sequences of at least this many tokens to the head-packed
# kernel. Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py's
# sweep over N = 32 ... 784 (64 sequences x 8 heads x 16, bf16): the
# tensor-core forward kernel beats the plain sdpa route at every swept N,
# forward alone and forward + backward, by device time (4-28x) and by CUDA
# events, so every MobileViT stage (N = 784, 147, 32) takes the kernel.
# The JAX package keeps its own 512, a TPU measurement.
_PACKED_MIN_SEQ = 32

BACKENDS = ("auto", "xla", "packed", "pallas", "pallas_packed")


class MultiHeadAttention(nn.Module):
    """Input (..., N, embed_dim); leading axes are batch-like (MobileViT
    passes (B, P, N, D) with P = 8 patch positions)."""

    def __init__(self, embed_dim: int, heads: int = 8, dim_head: int = 16,
                 dropout: float = 0.0, backend: str = "auto",
                 sequence_axis: Optional[str] = None):
        super().__init__()
        if backend not in BACKENDS:
            raise ValueError(f"attention backend {backend!r} (valid: "
                             f"{BACKENDS})")
        self.embed_dim = embed_dim
        self.heads = heads
        self.dim_head = dim_head
        self.inner_dim = heads * dim_head
        self.scale = dim_head ** -0.5
        self.dropout_p = dropout
        self.backend = backend
        self.sequence_axis = sequence_axis
        self.norm = LayerNorm(embed_dim, affine=False)
        self.to_qkv = Linear(embed_dim, self.inner_dim * 3, bias=False)
        self.to_out = nn.Sequential(
            Linear(self.inner_dim, embed_dim, bias=False), Dropout(dropout))

    def uses_head_packed(self, n: int) -> bool:
        """Whether a sequence of ``n`` tokens takes the head-packed
        kernel."""
        if self.backend == "packed":
            return True
        return (self.backend == "auto" and self.inner_dim <= 128
                and n >= _PACKED_MIN_SEQ)

    def _forward_sp(self, qkv, dropout: float):
        from picklebot_tpu_torch.ops.ring_attention import ring_attention
        from picklebot_tpu_torch.parallel.sequence import all_gather_tokens
        q, k, v = (split_heads(t, self.heads) for t in qkv.chunk(3, dim=-1))
        if dropout > 0.0:
            # the dropped probabilities need whole score rows
            k = all_gather_tokens(k, self.sequence_axis)
            v = all_gather_tokens(v, self.sequence_axis)
            out = sdpa(q, k, v, self.scale, dropout_p=dropout)
        else:
            out = ring_attention(q, k, v, self.sequence_axis, self.scale)
        return self.to_out(merge_heads(out))

    def forward(self, x, kernels: bool = True, sp_active: bool = False):
        dropout = self.dropout_p if self.training else 0.0
        if sp_active:
            return self._forward_sp(self.to_qkv(self.norm(x)), dropout)
        kernels = kernels and dropout == 0.0
        x = self.norm(x)
        qkv = self.to_qkv(x)                            # (..., N, 3*H*D)
        if kernels and self.uses_head_packed(x.shape[-2]):
            q, k, v = qkv.chunk(3, dim=-1)
            out = flash_attention_packed(q, k, v, self.heads, self.scale)
        elif kernels and self.backend == "pallas_packed":
            out = flash_attention_qkvpacked(
                qkv.unflatten(-1, (3, self.heads, self.dim_head)),
                self.scale).flatten(-2)
        else:
            q, k, v = (split_heads(t, self.heads)
                       for t in qkv.chunk(3, dim=-1))
            if kernels and self.backend == "pallas":
                out = flash_attention(q, k, v, self.scale)
            else:
                out = sdpa(q, k, v, self.scale, dropout_p=dropout)
            out = merge_heads(out)
        return self.to_out(out)


class LinearSelfAttention(nn.Module):
    """MobileViTV2's separable attention on (B, P, N, C): P pixels per
    patch, N patches. ``qkv_proj`` (the reference's 1x1 Conv2d, weight
    (1+2C, C, 1, 1)) gives one query channel, C key and C value channels;
    the query's softmax over N in f32, cast to x's dtype, weighs the keys
    into one context vector per pixel position, which scales relu(value)
    before ``out_proj``."""

    def __init__(self, embed_dim: int, dropout: float = 0.0):
        super().__init__()
        self.embed_dim = embed_dim
        self.qkv_proj = Dense(embed_dim, 1 + 2 * embed_dim, rank=4)
        self.attn_dropout = Dropout(dropout)
        self.out_proj = Dense(embed_dim, embed_dim, rank=4)

    def forward(self, x):
        c = self.embed_dim
        query, key, value = self.qkv_proj(x).split([1, c, c], dim=-1)
        scores = torch.softmax(query.float(), dim=-2).to(x.dtype)
        scores = self.attn_dropout(scores)
        context = (key * scores).sum(dim=-2, keepdim=True)   # (B, P, 1, C)
        return self.out_proj(torch.relu(value) * context)
