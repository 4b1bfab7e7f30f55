"""Multi-head attention as MobileViT uses it.

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
run their plain versions. ``forward(x, kernels=False)`` runs ``sdpa``
whatever the backend, on the card too: the reference the kernels are held
against. Sequence parallelism and train-mode attention dropout are not
ported (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

from torch import nn

from picklebot_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_packed, flash_attention_qkvpacked,
    merge_heads, sdpa, split_heads)
from picklebot_tpu_torch.ops.linear import Dropout, Linear
from picklebot_tpu_torch.ops.norm import LayerNorm

# The JAX package's threshold for 'auto' (a TPU measurement, kept so that
# the port runs the same path; re-measuring it on the card is queued in
# ROADMAP.md).
_PACKED_MIN_SEQ = 512

BACKENDS = ("auto", "xla", "packed", "pallas", "pallas_packed")


class MultiHeadAttention(nn.Module):
    """Input (..., N, embed_dim); leading axes are batch-like (MobileViT
    passes (B, P, N, D) with P = 8 patch positions)."""

    def __init__(self, embed_dim: int, heads: int = 8, dim_head: int = 16,
                 dropout: float = 0.0, backend: str = "auto",
                 sequence_axis: Optional[str] = None):
        super().__init__()
        if sequence_axis is not None:
            raise NotImplementedError(
                "sequence-parallel attention comes with the parallel "
                "layouts slice of the port (ROADMAP.md, queue A, slice 7)")
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

    def forward(self, x, kernels: bool = True):
        if self.training and self.dropout_p > 0:
            raise NotImplementedError(
                "attention dropout in train mode comes with the training "
                "slice of the port (ROADMAP.md, queue A, slice 2)")
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
                out = sdpa(q, k, v, self.scale)
            out = merge_heads(out)
        return self.to_out(out)
