"""Flash attention: softmax(scale * Q K^T) V and its gradients without the
(N, N) score matrix in device memory.

Counterpart of ``picklebot_tpu/ops/pallas/flash_packed.py`` (forward
``_fwd_kernel`` / ``_fwd_kernel_nolse``, backward ``_dq_kernel`` /
``_dkv_kernel``) and ``picklebot_tpu/ops/pallas/flash_attention.py`` (the
same three per head). On a CUDA tensor the work runs in the hand-written
kernels of ``csrc/flash_attention.cu`` (see the note there for their bounds
on the H100 and their design); on a CPU tensor each function computes its
plain PyTorch version instead. ``LAUNCHES`` counts kernel launches: the
forward per entry, the backward per kernel (one dQ and one dK/dV launch
per backward, whatever the layout):

  packed  ``flash_attention_packed``: (..., N, H*D), heads side by side in
          the last axis, as the fused qkv projection leaves them. The
          kernels read q, k and v in place through their strides (the
          qkv split's views have token stride 3*H*D): no copies.
  heads   ``flash_attention`` on (..., N, D), one head per sequence, and
          ``flash_attention_qkvpacked`` on (..., N, 3, H, D) ->
          (..., N, H, D), both read in place where the leading axes merge.

The layouts at these functions are the JAX package's. When autograd is on
and an input requires grad, each entry runs a ``torch.autograd.Function``:
its forward is the kernel with the f32 logsumexp, its backward computes
D = rowsum(dO * O) in f32 in torch, then launches the dQ and the dK/dV
kernels (on the CPU: the plain forward with lse and
``flash_backward_reference``). Otherwise the forward runs alone, without
the lse. In bf16 every kernel runs on the tensor cores (``_forward_plan``,
``_backward_plan``) and copies rows in 16-byte pieces, so a view whose
rows do not start on 16 bytes is refused (``_rows_aligned16``), never
copied; the views the model hands on (the qkv split's chunks, split
heads, the qkv-packed select) are aligned. Numerics follow the Pallas
kernels: f32 scores and softmax statistics, P rounded to v's dtype before
the PV product (to dO's before dV), dS to the inputs' dtype before dQ and
dK, f32 accumulation, outputs cast at the end. The plain forward is ``sdpa`` (the JAX package's
``sdpa_xla``: f32 logits and softmax, probabilities rounded to v's dtype,
the product accumulated in f32) with split and merged heads. The three
forwards without lse are also the custom ops ``picklebot::flash_packed``,
``picklebot::flash_heads`` and ``picklebot::flash_qkvpacked``
(``ops/library.py``), through which a traced call goes, so that an
exported program keeps them.
"""

from __future__ import annotations

import collections
import ctypes
import math

import torch

from picklebot_tpu_torch.ops import library
from picklebot_tpu_torch.ops.linear import dropout_mask

LAUNCHES = {"packed": 0, "heads": 0, "dq": 0, "dkv": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64)
_ROWS = 64              # rows per block of every flash kernel
_FNS = {}


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------

def sdpa(q, k, v, scale: float, with_lse: bool = False,
         dropout_p: float = 0.0):
    """Softmax attention over (..., N, D): f32 logits and softmax, the
    probabilities rounded to v's dtype, the product accumulated in f32
    and cast to v's dtype. With ``with_lse`` also the f32 (..., N)
    logsumexp of the scaled logits. ``dropout_p`` > 0 drops f32
    probabilities (inverted scaling) with a mask from the current
    ``dropout_rng`` before the rounding, as ``sdpa_xla`` does in train
    mode."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = 1.0 - dropout_p
        probs = torch.where(dropout_mask(probs.shape, keep, probs.device),
                            probs / keep, 0.0)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    if with_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def flash_backward_reference(q, k, v, o, lse, do, scale: float):
    """Plain version of the backward kernels, per head: q, k, v, the
    forward's output o and the incoming gradient do (..., N, D), its f32
    lse (..., N) -> (dq, dk, dv) in the inputs' dtype. The same algebra
    and roundings as the kernels: P = exp(scale * q k^T - lse), dP = do
    v^T, D = rowsum(do * o), dS = P * (dP - D); dV = round(P)^T do,
    dQ = scale * round(dS) k, dK = scale * round(dS)^T q, in f32."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    p = torch.exp(torch.matmul(qf, kf.transpose(-1, -2)) * scale
                  - lse[..., None])
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    dd = (dof * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - dd)).to(q.dtype).float()
    dv = torch.matmul(p.to(do.dtype).float().transpose(-1, -2), dof)
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def split_heads(t, heads: int):
    """(..., N, H*D) -> (..., H, N, D), a view."""
    return t.unflatten(-1, (heads, t.shape[-1] // heads)).transpose(-2, -3)


def merge_heads(t):
    """(..., H, N, D) -> (..., N, H*D)."""
    return t.transpose(-2, -3).flatten(-2)


def _qkv_split(qkv):
    """(..., N, 3, H, D) -> q, k, v views (..., H, N, D)."""
    return [qkv.select(-3, i).transpose(-2, -3) for i in range(3)]


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
    return flash_attention_reference(*_qkv_split(qkv),
                                     scale).transpose(-2, -3)


# --------------------------------------------------------------------------
# kernels
# --------------------------------------------------------------------------

def _fn(name):
    if not _FNS:
        from picklebot_tpu_torch.utils.build import load_library
        lib = load_library("flash_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fa_fwd.argtypes = [p] * 5 + [i] * 5 + [f, p, p]
        for bwd in (lib.fa_bwd_dq, lib.fa_bwd_dkv):
            bwd.argtypes = [p] * 9 + [i] * 5 + [f, p, p]
        for fn in (lib.fa_fwd, lib.fa_bwd_dq, lib.fa_bwd_dkv):
            fn.restype = i
        _FNS.update(fwd=lib.fa_fwd, dq=lib.fa_bwd_dq, dkv=lib.fa_bwd_dkv)
    return _FNS[name]


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


def _strides(views):
    """(s, h, n) strides of (S, H, N, D) views, each with stride 1
    along D."""
    d = views[0].shape[-1]
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {d} (takes "
                         f"{_HEAD_DIMS})")
    out = []
    for t in views:
        if t.stride(-1) != 1:
            raise ValueError("flash attention kernel: the head dim must "
                             "have stride 1")
        out += t.stride()[:3]
    return out


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"flash attention {what} kernel: launch failed "
                           f"with CUDA error {err}")


def _launch(q4, k4, v4, o4, lse3, scale: float):
    """One forward launch on (S, H, N, D) views, stride 1 along D; lse3 an
    f32 (S, H, N) view with stride 1 along N, or None. bf16 views must pass
    ``_rows_aligned16``: an unaligned one is refused, not copied."""
    s, h, n, d = q4.shape
    views = (q4, k4, v4, o4)
    strides = _strides(views)
    ptrs = [t.data_ptr() for t in views]
    _refuse_unaligned(_forward_plan(q4.shape, q4.dtype), ptrs, strides,
                      (s, h, n), "forward")
    if lse3 is not None:
        assert lse3.dtype == torch.float32 and lse3.stride(-1) == 1
        strides += lse3.stride()[:2]
    else:
        strides += [0, 0]
    arr = (ctypes.c_longlong * 14)(*strides)
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn("fwd")(*ptrs, 0 if lse3 is None else lse3.data_ptr(),
                         _DTYPES[q4.dtype], s, h, n, d, float(scale),
                         ctypes.addressof(arr), stream)
    _raise_on(err, "forward")


def _backward_d(o4, g4):
    """D = rowsum(dO * O) in f32: the contiguous (S, H, N) tensor that
    the backward kernels read beside lse."""
    return (g4.float() * o4.float()).sum(-1).contiguous()


KernelPlan = collections.namedtuple("KernelPlan",
                                    "kernel threads rows blocks")
ForwardPlan = BackwardPlan = KernelPlan


def _kernel_plan(shape, dtype) -> KernelPlan:
    """How ``csrc/flash_attention.cu`` runs the forward, the dQ and the
    dK/dV kernel on (S, H, N, D): bf16 on the tensor cores (``mma``: 4
    warps of 16 rows), f32 on the FMA kernels (``fma``: one thread per
    row); either way one block per (sequence, head, 64-row tile) of
    queries (forward, dQ) or keys (dK/dV)."""
    s, h, n, d = shape
    if d not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel: head dim {d} (takes "
                         f"{_HEAD_DIMS})")
    blocks = s * h * -(-n // _ROWS)
    if blocks > 2 ** 31 - 1:
        raise ValueError(f"flash attention kernel: {blocks} blocks, more "
                         "than a grid takes")
    return KernelPlan("mma" if dtype == torch.bfloat16 else "fma",
                      128 if dtype == torch.bfloat16 else 64, _ROWS, blocks)


_forward_plan = _backward_plan = _kernel_plan


def _rows_aligned16(ptrs, strides, sizes) -> bool:
    """True when every row start of bf16 (S, H, N, D) views lies on 16
    bytes, as the bf16 kernels copy rows in 16-byte pieces: each
    base pointer of ``ptrs`` a multiple of 16, and each of the views' (s,
    h, n) ``strides`` (``_strides``) on an axis longer than 1 (``sizes``:
    S, H, N) a multiple of 8 elements."""
    return not (any(p % 16 for p in ptrs) or any(
        st % 8 for i, st in enumerate(strides) if sizes[i % 3] > 1))


def _refuse_unaligned(plan: KernelPlan, ptrs, strides, sizes, what: str):
    """Raise when the bf16 (tensor-core) kernels would get views whose
    rows do not start on 16 bytes (``_rows_aligned16``)."""
    if plan.kernel == "mma" and not _rows_aligned16(ptrs, strides, sizes):
        raise ValueError(f"flash attention {what}: a bf16 view's rows do "
                         "not start on 16 bytes (the kernels copy rows in "
                         "16-byte pieces); pass tensors whose base and "
                         "strides are multiples of 8 elements")


def _launch_backward_kernel(name, q4, k4, v4, g4, lse3, dd, dq4, dk4, dv4,
                            scale: float):
    """One launch of the ``dq`` or the ``dkv`` kernel on (S, H, N, D)
    views (g4 the gradient of the forward's output, dq4/dk4/dv4 the
    outputs to fill) with the contiguous f32 (S, H, N) lse3 and dd. bf16
    views must pass ``_rows_aligned16``: an unaligned one is refused, not
    copied."""
    s, h, n, d = q4.shape
    for t in (lse3, dd):
        if t.dtype != torch.float32 or t.shape != (s, h, n) or \
                not t.is_contiguous():
            raise ValueError("flash attention backward: lse and D must be "
                             f"contiguous f32 {(s, h, n)} tensors")
    views = (q4, k4, v4, g4, dq4, dk4, dv4)
    strides = _strides(views)
    ptrs = [t.data_ptr() for t in views]
    _refuse_unaligned(_backward_plan(q4.shape, q4.dtype), ptrs, strides,
                      (s, h, n), "backward")
    arr = (ctypes.c_longlong * 23)(*strides, *dd.stride()[:2])
    with torch.cuda.device(q4.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _fn(name)(*ptrs[:4], lse3.data_ptr(), dd.data_ptr(),
                        *ptrs[4:], _DTYPES[q4.dtype], s, h, n, d,
                        float(scale), ctypes.addressof(arr), stream)
    _raise_on(err, name)
    LAUNCHES[name] += 1


def _launch_backward(q4, k4, v4, o4, g4, lse3, dq4, dk4, dv4,
                     scale: float):
    """D, then the dQ and the dK/dV launches (o4 the forward's output)."""
    dd = _backward_d(o4, g4)
    for name in ("dq", "dkv"):
        _launch_backward_kernel(name, q4, k4, v4, g4, lse3, dd, dq4, dk4,
                                dv4, scale)


def _as_seq_head(t):
    """(..., H, N, D) -> (S, H, N, D) (H = 1 for a 2-D input), a view
    unless the leading axes cannot merge into one stride."""
    lead = t.shape[:-2]
    h = lead[-1] if lead else 1
    return t.reshape(math.prod(lead) // h, h, *t.shape[-2:])


def _packed_views(heads, *ts):
    """(..., N, H*D) -> (S, H, N, D) views (copies for an input whose
    leading axes cannot merge; outputs are allocated contiguous)."""
    n, inner = ts[0].shape[-2:]
    s = math.prod(ts[0].shape[:-2])
    return [t.reshape(s, n, heads, inner // heads).transpose(1, 2)
            for t in ts]


# The forward kernel's arguments for each entry: the new output (and lse)
# tensors, and the (S, H, N, D) views of q, k, v and the output, with the
# (S, H, N) lse view or None, that the kernel reads and fills.

def _packed_forward_views(q, k, v, heads, with_lse):
    lead, n = q.shape[:-2], q.shape[-2]
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = (torch.empty(lead + (heads, n), device=q.device,
                       dtype=torch.float32) if with_lse else None)
    q4, k4, v4, o4 = _packed_views(heads, q, k, v, out)
    return out, lse, (q4, k4, v4, o4,
                      None if lse is None else lse.view(q4.shape[:3]))


def _heads_forward_views(q, k, v, with_lse):
    q4 = _as_seq_head(q)
    out = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    lse = (torch.empty(q.shape[:-1], device=q.device, dtype=torch.float32)
           if with_lse else None)
    return out, lse, (q4, _as_seq_head(k), _as_seq_head(v),
                      out.view(q4.shape),
                      None if lse is None else lse.view(q4.shape[:3]))


def _qkvpacked_forward_views(qkv, with_lse):
    """The output is (..., N, H, D), written through its (S, H, N, D)
    view."""
    q, k, v = _qkv_split(qkv)
    q4 = _as_seq_head(q)
    s, h, n, d = q4.shape
    out = torch.empty(qkv.shape[:-3] + qkv.shape[-2:], device=qkv.device,
                      dtype=qkv.dtype)
    lse = (torch.empty(q.shape[:-1], device=qkv.device, dtype=torch.float32)
           if with_lse else None)
    return out, lse, (q4, _as_seq_head(k), _as_seq_head(v),
                      out.view(s, n, h, d).transpose(1, 2),
                      None if lse is None else lse.view(s, h, n))


def _packed_launch(q, k, v, heads, scale, with_lse):
    """(out, lse or None) from the kernel on CUDA tensors."""
    _check(q, k, v)
    out, lse, views = _packed_forward_views(q, k, v, heads, with_lse)
    _launch(*views, scale)
    LAUNCHES["packed"] += 1
    return out, lse


def _heads_launch(q, k, v, scale, with_lse):
    _check(q, k, v)
    out, lse, views = _heads_forward_views(q, k, v, with_lse)
    _launch(*views, scale)
    LAUNCHES["heads"] += 1
    return out, lse


def _qkvpacked_launch(qkv, scale, with_lse):
    _check(*_qkv_split(qkv))
    out, lse, views = _qkvpacked_forward_views(qkv, with_lse)
    _launch(*views, scale)
    LAUNCHES["heads"] += 1
    return out, lse


def _packed_forward(q, k, v, heads, scale, with_lse):
    """(out, lse or None): the kernel on a CUDA tensor, the plain version
    on a CPU one."""
    if q.device.type == "cpu":
        res = flash_attention_packed_reference(q, k, v, heads, scale,
                                               with_lse)
        return res if with_lse else (res, None)
    return _packed_launch(q, k, v, heads, scale, with_lse)


def _heads_forward(q, k, v, scale, with_lse):
    if q.device.type == "cpu":
        res = sdpa(q, k, v, scale, with_lse)
        return res if with_lse else (res, None)
    return _heads_launch(q, k, v, scale, with_lse)


def _qkvpacked_forward(qkv, scale, with_lse):
    if qkv.device.type == "cpu":
        res = sdpa(*_qkv_split(qkv), scale, with_lse)
        out, lse = res if with_lse else (res, None)
        return out.transpose(-2, -3), lse
    return _qkvpacked_launch(qkv, scale, with_lse)


# The inference forwards (no lse) as custom ops (ops/library.py): the
# launch on CUDA tensors, the plain version on CPU ones, the output's
# shape and dtype in the fake.

@torch.library.custom_op(f"{library.NAMESPACE}::flash_packed",
                         mutates_args=(), device_types="cuda")
def _packed_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               heads: int, scale: float) -> torch.Tensor:
    return _packed_launch(q, k, v, heads, scale, False)[0]


@_packed_op.register_kernel("cpu")
def _packed_op_cpu(q, k, v, heads, scale):
    return flash_attention_packed_reference(q, k, v, heads, scale)


@_packed_op.register_fake
def _packed_op_fake(q, k, v, heads, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{library.NAMESPACE}::flash_heads",
                         mutates_args=(), device_types="cuda")
def _heads_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    return _heads_launch(q, k, v, scale, False)[0]


@_heads_op.register_kernel("cpu")
def _heads_op_cpu(q, k, v, scale):
    return sdpa(q, k, v, scale)


@_heads_op.register_fake
def _heads_op_fake(q, k, v, scale):
    return q.new_empty(q.shape)


@torch.library.custom_op(f"{library.NAMESPACE}::flash_qkvpacked",
                         mutates_args=(), device_types="cuda")
def _qkvpacked_op(qkv: torch.Tensor, scale: float) -> torch.Tensor:
    return _qkvpacked_launch(qkv, scale, False)[0]


@_qkvpacked_op.register_kernel("cpu")
def _qkvpacked_op_cpu(qkv, scale):
    return sdpa(*_qkv_split(qkv), scale).transpose(-2, -3).contiguous()


@_qkvpacked_op.register_fake
def _qkvpacked_op_fake(qkv, scale):
    return qkv.new_empty((*qkv.shape[:-3], *qkv.shape[-2:]))


def _needs_graph(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


# The backward kernels' arguments for each Function: (S, H, N, D) views of
# q, k, v, the forward's output and its gradient, the (S, H, N) lse, then
# views of the new gradient tensors that the kernels fill; returned beside
# those tensors.

def _packed_backward_views(q, k, v, out, lse, g, heads):
    grads = [torch.empty(q.shape, device=q.device, dtype=q.dtype)
             for _ in range(3)]
    views = _packed_views(heads, q, k, v, out, g.contiguous(), *grads)
    return grads, (*views[:5], lse.view(views[0].shape[:3]), *views[5:])


def _heads_backward_views(q, k, v, out, lse, g):
    q4 = _as_seq_head(q)
    grads = [torch.empty(q.shape, device=q.device, dtype=q.dtype)
             for _ in range(3)]
    return grads, (q4, _as_seq_head(k), _as_seq_head(v), out.view(q4.shape),
                   g.contiguous().view(q4.shape), lse.view(q4.shape[:3]),
                   *(t.view(q4.shape) for t in grads))


def _qkvpacked_backward_views(qkv, out, lse, g):
    """The gradient is one (..., N, 3, H, D) tensor, written in place
    through its q, k and v views."""
    q4, k4, v4 = (_as_seq_head(t) for t in _qkv_split(qkv))
    s, h, n, d = q4.shape
    dqkv = torch.empty(qkv.shape, device=qkv.device, dtype=qkv.dtype)
    grads = [dqkv.view(s, n, 3, h, d).select(2, i).transpose(1, 2)
             for i in range(3)]
    heads = [t.view(s, n, h, d).transpose(1, 2)
             for t in (out, g.contiguous())]
    return dqkv, (q4, k4, v4, *heads, lse.view(s, h, n), *grads)


class FlashPackedFn(torch.autograd.Function):
    """``flash_attention_packed`` under autograd: the forward kernel with
    lse, then D, the dQ and the dK/dV kernels."""

    @staticmethod
    def forward(ctx, q, k, v, heads, scale):
        out, lse = _packed_forward(q, k, v, heads, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        heads, scale = ctx.heads, ctx.scale
        if q.device.type == "cpu":
            grads = flash_backward_reference(
                *(split_heads(t, heads) for t in (q, k, v, out)), lse,
                split_heads(g, heads), scale)
            return (*(merge_heads(t) for t in grads), None, None)
        grads, views = _packed_backward_views(q, k, v, out, lse, g, heads)
        _launch_backward(*views, scale)
        return (*grads, None, None)


class FlashFn(torch.autograd.Function):
    """``flash_attention`` under autograd (per head)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = _heads_forward(q, k, v, scale, True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            return (*flash_backward_reference(q, k, v, out, lse, g,
                                              ctx.scale), None)
        grads, views = _heads_backward_views(q, k, v, out, lse, g)
        _launch_backward(*views, ctx.scale)
        return (*grads, None)


class FlashQKVPackedFn(torch.autograd.Function):
    """``flash_attention_qkvpacked`` under autograd: the gradient is one
    (..., N, 3, H, D) tensor, which the backward kernels write in place
    through its q, k and v views."""

    @staticmethod
    def forward(ctx, qkv, scale):
        out, lse = _qkvpacked_forward(qkv, scale, True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, out, lse = ctx.saved_tensors
        if qkv.device.type == "cpu":
            grads = flash_backward_reference(
                *_qkv_split(qkv), out.transpose(-2, -3), lse,
                g.transpose(-2, -3), ctx.scale)
            return torch.stack([t.transpose(-2, -3) for t in grads],
                               dim=-3), None
        dqkv, views = _qkvpacked_backward_views(qkv, out, lse, g)
        _launch_backward(*views, ctx.scale)
        return dqkv, None


def flash_attention_packed(q, k, v, heads: int, scale=None,
                           with_lse: bool = False):
    """Head-packed flash attention: q, k, v (..., N, H*D) -> (..., N, H*D)
    in q's dtype, and with ``with_lse`` (no autograd) also the f32
    (..., H, N) logsumexp. The kernels on a CUDA tensor, the plain
    versions on a CPU one; differentiable (``FlashPackedFn``)."""
    scale = _packed_scale(q, heads, scale)
    if _needs_graph(q, k, v):
        if with_lse:
            raise NotImplementedError(
                "flash attention: the lse is the backward's residual and "
                "has no gradient; ask for it under torch.no_grad()")
        return FlashPackedFn.apply(q, k, v, heads, scale)
    if library.use_ops() and not with_lse:
        return _packed_op(q, k, v, heads, scale)
    out, lse = _packed_forward(q, k, v, heads, scale, with_lse)
    return (out, lse) if with_lse else out


def flash_attention(q, k, v, scale=None):
    """Per-head flash attention over (..., N, D) -> (..., N, D). The
    kernels on a CUDA tensor, the plain versions on a CPU one;
    differentiable (``FlashFn``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    if _needs_graph(q, k, v):
        return FlashFn.apply(q, k, v, scale)
    if library.use_ops():
        return _heads_op(q, k, v, scale)
    return _heads_forward(q, k, v, scale, False)[0]


def flash_attention_qkvpacked(qkv, scale=None):
    """Packed-qkv entry: qkv (..., N, 3, H, D) -> (..., N, H, D), the
    per-head kernels reading q, k and v in place; differentiable
    (``FlashQKVPackedFn``)."""
    if qkv.shape[-3] != 3:
        raise ValueError(f"expected (..., N, 3, H, D), got "
                         f"{tuple(qkv.shape)}")
    scale = qkv.shape[-1] ** -0.5 if scale is None else scale
    if _needs_graph(qkv):
        return FlashQKVPackedFn.apply(qkv, scale)
    if library.use_ops():
        return _qkvpacked_op(qkv, scale)
    return _qkvpacked_forward(qkv, scale, False)[0]
