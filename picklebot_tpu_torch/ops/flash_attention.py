"""Flash-attention forward: softmax(scale * Q K^T) V without the (N, N) score
matrix in device memory.

Counterpart of ``picklebot_tpu/ops/pallas/flash_packed.py`` (forward:
``_fwd_kernel`` / ``_fwd_kernel_nolse``) and
``picklebot_tpu/ops/pallas/flash_attention.py`` (forward ``_fwd_kernel``).
On a CUDA tensor the work runs in the hand-written kernel of
``csrc/flash_attention.cu`` (see the note there for its bound on the H100
and its design); on a CPU tensor each function computes its plain PyTorch
version instead. ``LAUNCHES`` counts kernel launches per entry:

  packed  ``flash_attention_packed``: (..., N, H*D), heads side by side in
          the last axis, as the fused qkv projection leaves them. The
          kernel reads q, k and v in place through their strides (the
          qkv split's views have token stride 3*H*D): no copies.
  heads   ``flash_attention`` on (..., N, D), one head per sequence, and
          ``flash_attention_qkvpacked`` on (..., N, 3, H, D) ->
          (..., N, H, D), both read in place where the leading axes merge.

The layouts at these functions are the JAX package's. Only the forward is
ported: the backward kernels come with the MobileViT training slice
(ROADMAP.md). Numerics follow the Pallas kernels: f32 scores and softmax
statistics, P rounded to v's dtype before the PV product, accumulated in
f32, the output cast at the end. The plain versions are ``sdpa`` (the
JAX package's ``sdpa_xla``: f32 logits and softmax, probabilities rounded
to v's dtype, the product accumulated in f32) with split and merged heads.
"""

from __future__ import annotations

import ctypes
import math

import torch

LAUNCHES = {"packed": 0, "heads": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_FNS = {}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def sdpa(q, k, v, scale: float, with_lse: bool = False):
    """Softmax attention over (..., N, D): f32 logits and softmax, the
    probabilities rounded to v's dtype, the product accumulated in f32
    and cast to v's dtype. With ``with_lse`` also the f32 (..., N)
    logsumexp of the scaled logits."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(v.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def split_heads(t, heads: int):
    """(..., N, H*D) -> (..., H, N, D), a view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(-2, -3)


def merge_heads(t):
    """(..., H, N, D) -> (..., N, H*D)."""
    return t.transpose(-2, -3).flatten(-2)


def flash_attention_packed_reference(q, k, v, heads: int, scale=None,
                                     with_lse: bool = False):
    """Plain version of ``flash_attention_packed``: (out, lse) with lse
    f32 (..., H, N) when ``with_lse``, else out."""
    scale = _packed_scale(q, heads, scale)
    res = sdpa(split_heads(q, heads), split_heads(k, heads),
               split_heads(v, heads), scale, with_lse)
    if with_lse:
        return merge_heads(res[0]), res[1]
    return merge_heads(res)


def flash_attention_reference(q, k, v, scale=None):
    """Plain version of ``flash_attention``."""
    return sdpa(q, k, v, q.shape[-1] ** -0.5 if scale is None else scale)


def flash_attention_qkvpacked_reference(qkv, scale=None):
    """Plain version of ``flash_attention_qkvpacked``."""
    q, k, v = (qkv.select(-3, i).transpose(-2, -3) for i in range(3))
    return flash_attention_reference(q, k, v, scale).transpose(-2, -3)


# --------------------------------------------------------------------------
# kernel
# --------------------------------------------------------------------------

def _fn():
    if "fwd" not in _FNS:
        from picklebot_tpu_torch.utils.build import load_library
        lib = load_library("flash_attention")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fa_fwd.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float, p, p]
        lib.fa_fwd.restype = i
        _FNS["fwd"] = lib.fa_fwd
    return _FNS["fwd"]


def _packed_scale(q, heads, scale):
    if q.shape[-1] % heads:
        raise ValueError(f"inner dim {q.shape[-1]} is not a multiple of "
                         f"{heads} heads")
    return (q.shape[-1] // heads) ** -0.5 if scale is None else scale


def _check(q, k, v):
    for t in (q, k, v):
        if t.device.type != "cuda":
            raise ValueError(f"flash attention kernel: a tensor is on "
                             f"{t.device}; the kernel runs on CUDA tensors "
                             "only")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash attention kernel: dtype {q.dtype} "
                        "(float32 or bfloat16 only)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{name} is {t.dtype} {tuple(t.shape)}, q is "
                             f"{q.dtype} {tuple(q.shape)}")


def _launch(q4, k4, v4, o4, lse3, scale: float):
    """One kernel launch on (S, H, N, D) views, stride 1 along D; lse3 an
    f32 (S, H, N) view with stride 1 along N, or None."""
    s, h, n, d = q4.shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {d} (takes "
                         f"{_HEAD_DIMS})")
    strides = []
    for t in (q4, k4, v4, o4):
        if t.stride(-1) != 1:
            raise ValueError("flash attention kernel: the head dim must "
                             "have stride 1")
        strides += t.stride()[:3]
    if lse3 is not None:
        assert lse3.dtype == torch.float32 and lse3.stride(-1) == 1
        strides += lse3.stride()[:2]
    else:
        strides += [0, 0]
    arr = (ctypes.c_longlong * 14)(*strides)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn()(q4.data_ptr(), k4.data_ptr(), v4.data_ptr(),
                    o4.data_ptr(), 0 if lse3 is None else lse3.data_ptr(),
                    _DTYPES[q4.dtype], s, h, n, d, float(scale),
                    ctypes.addressof(arr), stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel: launch failed with "
                           f"CUDA error {err}")


def _as_seq_head(t):
    """(..., H, N, D) -> (S, H, N, D) (H = 1 for a 2-D input), a view
    unless the leading axes cannot merge into one stride."""
    lead = t.shape[:-2]
    h = lead[-1] if lead else 1
    return t.reshape(math.prod(lead) // h, h, *t.shape[-2:])


def flash_attention_packed(q, k, v, heads: int, scale=None,
                           with_lse: bool = False):
    """Head-packed flash attention: q, k, v (..., N, H*D) -> (..., N, H*D)
    in q's dtype, and with ``with_lse`` also the f32 (..., H, N)
    logsumexp. The kernel on a CUDA tensor, the plain version on a CPU
    one."""
    if q.device.type == "cpu":
        return flash_attention_packed_reference(q, k, v, heads, scale,
                                                with_lse)
    _check(q, k, v)
    scale = _packed_scale(q, heads, scale)
    lead, (n, inner) = q.shape[:-2], q.shape[-2:]
    s = math.prod(lead)

    def view(t):        # (..., N, H*D) -> (S, H, N, D), in place if it can
        return t.reshape(s, n, heads, inner // heads).transpose(1, 2)

    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = (torch.empty(lead + (heads, n), device=q.device,
                       dtype=torch.float32) if with_lse else None)
    _launch(view(q), view(k), view(v),
            out.view(s, n, heads, -1).transpose(1, 2),
            None if lse is None else lse.view(s, heads, n), scale)
    LAUNCHES["packed"] += 1
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, scale=None):
    """Per-head flash attention over (..., N, D) -> (..., N, D). The
    kernel on a CUDA tensor, the plain version on a CPU one."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    _check(q, k, v)
    q4 = _as_seq_head(q)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    _launch(q4, _as_seq_head(k), _as_seq_head(v), out.view(q4.shape), None,
            q.shape[-1] ** -0.5 if scale is None else scale)
    LAUNCHES["heads"] += 1
    return out


def flash_attention_qkvpacked(qkv, scale=None):
    """Packed-qkv entry: qkv (..., N, 3, H, D) -> (..., N, H, D), the
    per-head kernel reading q, k and v in place."""
    if qkv.shape[-3] != 3:
        raise ValueError(f"expected (..., N, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    if qkv.device.type == "cpu":
        return flash_attention_qkvpacked_reference(qkv, scale)
    q, k, v = (qkv.select(-3, i).transpose(-2, -3) for i in range(3))
    _check(q, k, v)
    q4 = _as_seq_head(q)
    s, h, n, d = q4.shape
    out = torch.empty(qkv.shape[:-3] + qkv.shape[-2:], device=qkv.device,
                      dtype=qkv.dtype)
    _launch(q4, _as_seq_head(k), _as_seq_head(v),
            out.view(s, n, h, d).transpose(1, 2), None,
            d ** -0.5 if scale is None else scale)
    LAUNCHES["heads"] += 1
    return out
