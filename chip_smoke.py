#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order (each prints JSON lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds every kernel from picklebot_tpu_torch/csrc/, one
              process per source, all started together; meanwhile the
              profiler's one-time start-up runs on a trivial op
  3. kernels  each kernel against its plain PyTorch version on the card:
              the fused bottleneck at the 15 MobileNetLarge3D and the 7
              MobileViT-s bottleneck geometries of a bs-8, 32x224x224 clip
              batch (bf16), plus one f32 case with TF32 off; the flash
              attention kernel, packed with and without lse at
              MobileViT-s's stage-1 shape, per head at its three stages'
              shapes and qkv-packed at stage 1 (bf16), f32 cases with
              TF32 off (packed with lse, per head and qkv-packed at a
              ragged N), and head dims 32 and 64; kernel, plain and
              library times by CUDA events, and bounds
  4. serve    picklebot_tpu_torch.serve.main on 16 synthetic clips at full
              width from a seeded .pth, for MobileNetLarge3D and for
              MobileViT-s ('auto' attention): checks the predictions, the
              exact kernel launches of each run (counts set to 0 just
              before it, read just after), and one batch's logits against
              the plain path on the card; then the predict throughput at
              bs 8, and a torch.profiler trace of one forward (device
              time by kernel, idle share; a trace without device events
              fails the run)
  5. pallas   one MobileViT-s forward each with attention_backend
              'pallas' and 'pallas_packed': 9 per-head flash launches
              each, logits against the plain path
  6. summary  {"kernels": [...]}, the card line, and last
              {"ok": true, "device": ...}
Per-shape numbers also go to chiprun_out/chip_smoke.json. Without CUDA
it exits with code 2 and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12                     # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense; f32 w/o TF32
# (B, T, H, W, C), k, s, SE, E, Co: MobileNetLarge3D's 15 bottlenecks at
# bs 8 and a (8, 32, 224, 224, 3) input
GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 1, False, 16, 16),
    ((8, 18, 112, 112, 16), 3, 2, False, 64, 24),
    ((8, 10, 56, 56, 24), 3, 1, False, 72, 24),
    ((8, 12, 56, 56, 24), 5, 2, True, 72, 40),
    ((8, 8, 28, 28, 40), 5, 1, True, 120, 40),
    ((8, 12, 28, 28, 40), 5, 1, True, 120, 40),
    ((8, 16, 28, 28, 40), 3, 2, False, 240, 80),
    ((8, 9, 14, 14, 80), 3, 1, False, 240, 80),
    ((8, 11, 14, 14, 80), 3, 1, False, 184, 80),
    ((8, 13, 14, 14, 80), 3, 1, False, 184, 80),
    ((8, 15, 14, 14, 80), 3, 1, True, 480, 112),
    ((8, 17, 14, 14, 112), 3, 1, True, 672, 112),
    ((8, 19, 14, 14, 112), 5, 2, True, 672, 160),
    ((8, 12, 7, 7, 160), 5, 1, True, 960, 160),
    ((8, 16, 7, 7, 160), 5, 1, True, 960, 160),
]
# MobileViT-s's 7 bottlenecks (stem[0..3], trunk[0..2][0]) at the same
# input; the serve phase checks that the model gives them these shapes
VIT_GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 1, False, 64, 32),
    ((8, 18, 112, 112, 32), 3, 2, False, 128, 64),
    ((8, 10, 56, 56, 64), 3, 1, False, 256, 64),
    ((8, 12, 56, 56, 64), 3, 1, False, 256, 64),
    ((8, 14, 56, 56, 64), 3, 2, False, 256, 96),
    ((8, 8, 28, 28, 96), 3, 2, False, 512, 128),
    ((8, 5, 14, 14, 128), 3, 2, False, 512, 160),
]
# MobileViT-s attention at bs 8: 64 sequences (8 clips x 8 patch
# positions) of N tokens, 8 heads of 16, per stage: (N, layers)
VIT_ATTENTION = [(784, 2), (147, 4), (32, 3)]
VIT_SEQS, VIT_HEADS, VIT_DHEAD = 64, 8, 16
# bf16: the plain path rounds the expanded and depthwise tensors to bf16
# (2^-9 relative each) where the kernel keeps them f32, so outputs differ
# by a few bf16 ulps of the output's range; 3% of max|plain| bounds that.
# The same bound holds the flash kernel in bf16: the JAX package's own
# bf16 bound for its flash kernel (tests/test_flash_packed.py), since the
# kernel rounds unnormalized probabilities to bf16 where the plain version
# rounds normalized ones.
BF16_REL_TOL = 3e-2
# bf16 flash, besides: rms(err) within 1% of rms(ref). Rounding moves each
# output by a few 2^-9 (rms ratio ~0.3%); a stride or layout fault moves
# every output by about its own size. max|ref| comes from a few peaked
# rows, ~25x the rms output at N=784, so the max bound alone is loose.
BF16_RMS_TOL = 1e-2
# f32 with TF32 off: the same f32 chain summed in another order.
F32_REL_TOL = 1e-4
FLASH_F32_REL_TOL = 2e-4     # online softmax against one softmax, f32
LSE_ABS_TOL = 1e-3           # f32 logsumexp of f32 scores, two orders
# logits after 15 blocks in bf16: the two paths' roundings random-walk
# through about 45 ops, sqrt(45) * 2^-9 ~ 1.3%; allow 5% of max|logit|.
LOGIT_REL_TOL = 5e-2


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=5):
    """Mean ms of ``fn`` over ``reps`` runs by CUDA events, after one
    warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def roofline(nbytes, flops, dtype_name):
    """Least time (ms) on an H100: max(bytes / 3.35 TB/s, FLOPs / peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def bound(shape, k, s, e, co, elem, pass_):
    """Least time for one fused-bottleneck pass at this geometry. Bytes:
    the input frames the output reads, the weights and the output, once
    each (no expanded tensor). FLOPs: expand over those frames, depthwise,
    and for the main pass the scale and projection (the pool pass's
    recompute is its own row)."""
    from picklebot_tpu_torch.ops.fused_bottleneck import out_shape
    b, t, h, w, c = shape
    to, ho, wo = out_shape(t, h, w, k, s)
    p = k // 2
    frames = b * sum(1 for i in range(to) if 0 <= i * s - p < t)
    nbytes = frames * h * w * c * elem + (c * e + k * k * e) * elem
    flops = 2 * frames * (h * w * c * e + ho * wo * k * k * e)
    if pass_ == "main":
        nbytes += e * co * elem + b * e * 4 + b * to * ho * wo * co * elem
        flops += frames * ho * wo * (e + 2 * e * co)
    else:
        nbytes += b * e * 4
        flops += frames * ho * wo * e
    return roofline(nbytes, flops, "bfloat16" if elem == 2 else "float32")


def flash_bound(s, h, n, d, elem, with_lse):
    """Least time for one flash-attention forward: Q, K, V read and O
    (and the f32 lse) written once; 4*N^2*D useful FLOPs per (sequence,
    head), QK^T and PV."""
    nbytes = 4 * s * h * n * d * elem + (s * h * n * 4 if with_lse else 0)
    return roofline(nbytes, 4 * s * h * n * n * d,
                    "bfloat16" if elem == 2 else "float32")


def make_case(shape, k, e, co, dtype, seed):
    """Seeded input and weights on the card, scaled like the model's
    (U(-1/sqrt(fan_in), 1/sqrt(fan_in)) weights, input in [0, 1))."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[-1]

    def u(*size, fan_in):
        b = fan_in ** -0.5
        return ((torch.rand(*size, generator=g, device="cuda") * 2 - 1)
                * b).to(dtype)

    x = torch.rand(*shape, generator=g, device="cuda").to(dtype)
    r = e // 4
    return x, dict(w1=u(c, e, fan_in=c), wd=u(k, k, e, fan_in=k * k),
                   w2=u(e, co, fan_in=e), se_w1=u(e, r, fan_in=e),
                   se_b1=u(r, fan_in=e), se_w2=u(r, e, fan_in=r),
                   se_b2=u(e, fan_in=r))


def library_chain(x, w, k, s, scale, project):
    """The unfused chain as cuDNN convolutions on the channels-last
    layout (timed as a yardstick only; the port never calls it)."""
    import torch.nn.functional as F
    e = w["w1"].shape[1]
    xc = x.permute(0, 4, 1, 2, 3)             # channels_last_3d view
    h = F.conv3d(xc, w["w1"].t().reshape(e, -1, 1, 1, 1))
    d = F.conv3d(h, w["wd"].permute(2, 0, 1).reshape(e, 1, 1, k, k),
                 stride=s, padding=k // 2, groups=e)
    if not project:
        return d.float().sum(dim=(2, 3, 4))
    d = d * scale.to(d.dtype)[:, :, None, None, None]
    return F.conv3d(d, w["w2"].t().reshape(-1, e, 1, 1, 1))


def check_close(name, got, want, rel_tol, abs_tol=0.0):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    ok = err <= rel_tol * ref + abs_tol + 1e-6
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} > {rel_tol} * "
                             f"max|ref| {ref} + {abs_tol}")
    return err, ref


def check_bf16_flash(name, got, want):
    """bf16 flash output against its plain version: max abs err within
    BF16_REL_TOL of max|ref| and rms err within BF16_RMS_TOL of rms(ref)."""
    err, ref = check_close(name, got, want, BF16_REL_TOL)
    rms_err = (got.float() - want.float()).pow(2).mean().sqrt().item()
    rms_ref = want.float().pow(2).mean().sqrt().item()
    if rms_err > BF16_RMS_TOL * rms_ref:
        raise AssertionError(f"{name}: rms err {rms_err} > {BF16_RMS_TOL} "
                             f"* rms(ref) {rms_ref}")
    return dict(err=err, max_ref=ref, rms_err=rms_err, rms_ref=rms_ref)


def fused_rows(model, geometries, seed0, reps):
    """The fused-bottleneck kernels against their plain versions at each
    geometry, with kernel, plain and cuDNN-chain times."""
    import torch
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    rows, per = [], {"pool": [], "main": []}
    for i, (shape, k, s, se, e, co) in enumerate(geometries):
        x, w = make_case(shape, k, e, co, torch.bfloat16, seed=seed0 + i)
        b, t, h, wd_, c = shape
        to, ho, wo = fb.out_shape(t, h, wd_, k, s)
        row = {"model": model, "block": i, "x": list(shape), "k": k,
               "s": s, "se": se, "E": e, "out": [b, to, ho, wo, co]}
        if se:
            want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
            got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
            torch.cuda.synchronize()
            err, ref = check_close(f"{model} pool block {i}", got, want,
                                   BF16_REL_TOL)
            per["pool"].append(dict(
                err=err, **bound(shape, k, s, e, co, 2, "pool"),
                ms=time_ms(lambda: fb.fused_pool(x, w["w1"], w["wd"], k,
                                                 s), reps),
                plain_ms=time_ms(lambda: fb.pool_reference(
                    x, w["w1"], w["wd"], k, s), reps),
                library_ms=time_ms(lambda: library_chain(
                    x, w, k, s, None, False), reps)))
            row["pool"] = dict(per["pool"][-1], max_ref=ref)
            scale = fb.se_scale(want / float(to * ho * wo), w["se_w1"],
                                w["se_b1"], w["se_w2"], w["se_b2"],
                                x.dtype)
        else:
            scale = torch.ones((b, e), device="cuda")
        want = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        got = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        torch.cuda.synchronize()
        if tuple(got.shape) != (b, to, ho, wo, co):
            raise AssertionError(f"{model} main block {i}: shape "
                                 f"{got.shape}")
        err, ref = check_close(f"{model} main block {i}", got, want,
                               BF16_REL_TOL)
        per["main"].append(dict(
            err=err, **bound(shape, k, s, e, co, 2, "main"),
            ms=time_ms(lambda: fb.fused_main(x, w["w1"], w["wd"], w["w2"],
                                             scale, k, s), reps),
            plain_ms=time_ms(lambda: fb.main_reference(
                x, w["w1"], w["wd"], w["w2"], scale, k, s), reps),
            library_ms=time_ms(lambda: library_chain(x, w, k, s, scale,
                                                     True), reps)))
        row["main"] = dict(per["main"][-1], max_ref=ref)
        emit({"phase": "kernels", **row})
        rows.append(row)
        del x, w, got, want
    return rows, per


def fused_f32_case():
    """One f32 case, TF32 off, tight tolerance: block3[0] (k5, s2, SE)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    shape, k, s, se, e, co = GEOMETRIES[3]
    x, w = make_case(shape, k, e, co, torch.float32, seed=100)
    with DtypePolicy.f32().precision():
        want_p = fb.pool_reference(x, w["w1"], w["wd"], k, s)
        got_p = fb.fused_pool(x, w["w1"], w["wd"], k, s)
        scale = torch.rand(want_p.shape, device="cuda",
                           generator=torch.Generator(
                               device="cuda").manual_seed(101))
        want_m = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k,
                                   s)
        got_m = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        torch.cuda.synchronize()
    f32 = {"pool": check_close("pool f32", got_p, want_p, F32_REL_TOL)[0],
           "main": check_close("main f32", got_m, want_m, F32_REL_TOL)[0]}
    emit({"phase": "kernels", "f32_case": "block3.0", "max_abs_err": f32,
          "rel_tol": F32_REL_TOL})


def seeded_qkv(n, dtype, seed):
    """A seeded (64, N, 3*128) qkv projection output on the card: its
    chunk(3, -1) views are q, k, v as MultiHeadAttention hands them on,
    its (64, N, 3, H, D) view the 'pallas_packed' layout."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(VIT_SEQS, n, 3 * VIT_HEADS * VIT_DHEAD, generator=g,
                       device="cuda").to(dtype)


def flash_rows(reps):
    """The flash kernel against its plain versions at MobileViT-s's
    shapes: packed with and without lse at stage 1, per head at every
    stage and qkv-packed at stage 1 (bf16); in f32 with TF32 off, packed
    with lse at stage 1, per head and qkv-packed at N=147 (the last key
    tile ragged); per head at head dims 32 and 64 (bf16). Rows carry the
    entry point and the ``LAUNCHES`` key it counts under."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    scale = d ** -0.5
    rows = []

    def sdpa_lib(q4, k4, v4):      # yardstick only; the port never calls it
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    def record(row, fn, plain, lib, elem, with_lse, n):
        row.update(flash_bound(VIT_SEQS, h, n, d, elem, with_lse),
                   ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps),
                   library_ms=time_ms(lib, reps))
        emit({"phase": "kernels", **row})
        rows.append(row)

    def heads_of(qkv5):            # (S, N, 3, H, D) -> q, k, v (S, H, N, D)
        return [qkv5.select(-3, i).transpose(-2, -3) for i in range(3)]

    # packed, stage 1, bf16, without and with lse
    n = VIT_ATTENTION[0][0]
    q, k, v = seeded_qkv(n, torch.bfloat16, seed=200).chunk(3, dim=-1)
    split = [fa.split_heads(t, h) for t in (q, k, v)]
    want, want_lse = fa.flash_attention_packed_reference(q, k, v, h,
                                                         with_lse=True)
    got = fa.flash_attention_packed(q, k, v, h)
    got2, lse = fa.flash_attention_packed(q, k, v, h, with_lse=True)
    torch.cuda.synchronize()
    held = check_bf16_flash("flash packed bf16", got, want)
    held2 = check_bf16_flash("flash packed bf16 (lse run)", got2, want)
    lse_err = check_close("flash packed bf16 lse", lse, want_lse, 0.0,
                          LSE_ABS_TOL)[0]
    record({"entry": "packed", "kernel": "packed", "n": n,
            "dtype": "bfloat16", "lse": False, **held},
           lambda: fa.flash_attention_packed(q, k, v, h),
           lambda: fa.flash_attention_packed_reference(q, k, v, h),
           lambda: sdpa_lib(*split), 2, False, n)
    record({"entry": "packed", "kernel": "packed", "n": n,
            "dtype": "bfloat16", "lse": True, **held2, "lse_err": lse_err},
           lambda: fa.flash_attention_packed(q, k, v, h, with_lse=True),
           lambda: fa.flash_attention_packed_reference(q, k, v, h,
                                                       with_lse=True),
           lambda: sdpa_lib(*split), 2, True, n)
    del q, k, v, split, want, want_lse, got, got2, lse

    # per head, every stage, bf16, on the split heads' views
    for n, _ in VIT_ATTENTION:
        split = [fa.split_heads(t, h) for t in seeded_qkv(
            n, torch.bfloat16, seed=300 + n).chunk(3, dim=-1)]
        want = fa.flash_attention_reference(*split)
        got = fa.flash_attention(*split)
        torch.cuda.synchronize()
        held = check_bf16_flash(f"flash per-head bf16 n={n}", got, want)
        record({"entry": "heads", "kernel": "heads", "n": n,
                "dtype": "bfloat16", "lse": False, **held},
               lambda: fa.flash_attention(*split),
               lambda: fa.flash_attention_reference(*split),
               lambda: sdpa_lib(*split), 2, False, n)
        del split, want, got

    # qkv-packed ('pallas_packed'), stage 1, bf16: q, k, v read in place
    # from the (64, N, 3, H, D) view of one projection output
    n = VIT_ATTENTION[0][0]
    qkv5 = seeded_qkv(n, torch.bfloat16, seed=350).unflatten(-1, (3, h, d))
    want = fa.flash_attention_qkvpacked_reference(qkv5)
    got = fa.flash_attention_qkvpacked(qkv5)
    torch.cuda.synchronize()
    if tuple(got.shape) != (VIT_SEQS, n, h, d):
        raise AssertionError(f"flash qkv-packed: shape {tuple(got.shape)}")
    held = check_bf16_flash("flash qkv-packed bf16", got, want)
    record({"entry": "qkvpacked", "kernel": "heads", "n": n,
            "dtype": "bfloat16", "lse": False, **held},
           lambda: fa.flash_attention_qkvpacked(qkv5),
           lambda: fa.flash_attention_qkvpacked_reference(qkv5),
           lambda: sdpa_lib(*heads_of(qkv5)), 2, False, n)
    del qkv5, want, got

    # f32, TF32 off
    f32 = {}
    with DtypePolicy.f32().precision():
        q, k, v = seeded_qkv(VIT_ATTENTION[0][0], torch.float32,
                             seed=400).chunk(3, dim=-1)
        want, want_lse = fa.flash_attention_packed_reference(
            q, k, v, h, with_lse=True)
        got, lse = fa.flash_attention_packed(q, k, v, h, with_lse=True)
        f32["packed n=784"] = check_close("flash packed f32", got, want,
                                          FLASH_F32_REL_TOL)[0]
        f32["packed n=784 lse"] = check_close(
            "flash packed f32 lse", lse, want_lse, 0.0, LSE_ABS_TOL)[0]
        qkv = seeded_qkv(147, torch.float32, seed=401)
        split = [fa.split_heads(t, h) for t in qkv.chunk(3, dim=-1)]
        f32["heads n=147"] = check_close(
            "flash per-head f32 n=147", fa.flash_attention(*split),
            fa.flash_attention_reference(*split), FLASH_F32_REL_TOL)[0]
        qkv5 = qkv.unflatten(-1, (3, h, d))
        f32["qkvpacked n=147"] = check_close(
            "flash qkv-packed f32 n=147", fa.flash_attention_qkvpacked(qkv5),
            fa.flash_attention_qkvpacked_reference(qkv5),
            FLASH_F32_REL_TOL)[0]
    emit({"phase": "kernels", "f32_case": "flash", "max_abs_err": f32,
          "rel_tol": FLASH_F32_REL_TOL, "lse_abs_tol": LSE_ABS_TOL})
    del q, k, v, want, want_lse, got, lse, qkv, split, qkv5

    # the kernel's other head dims (MobileViT uses 16): per head, bf16,
    # N=147, H*D = 128
    dims = {}
    for dh in (32, 64):
        split = [fa.split_heads(t, VIT_HEADS * VIT_DHEAD // dh)
                 for t in seeded_qkv(147, torch.bfloat16,
                                     seed=500 + dh).chunk(3, dim=-1)]
        dims[f"d={dh}"] = check_bf16_flash(
            f"flash per-head bf16 d={dh}", fa.flash_attention(*split),
            fa.flash_attention_reference(*split))
    emit({"phase": "kernels", "head_dims_case": "flash per-head n=147",
          **dims})
    return rows


def phase_kernels():
    rows, per = fused_rows("MobileNetLarge3D", GEOMETRIES, 0, reps=5)
    vit_rows, vit_per = fused_rows("MobileViT-s", VIT_GEOMETRIES, 50,
                                   reps=5)
    fused_f32_case()
    return rows + vit_rows, per, vit_per, flash_rows(reps=5)


def calibrate_batchnorm(model, x):
    """Set every BatchNorm's running statistics to those of its input on
    one batch (the plain path, on the card): a seeded random model then
    gives O(1) activations and logits whose argmax means something."""
    import torch
    from picklebot_tpu_torch.ops.norm import BatchNorm

    def hook(mod, args):
        v = args[0].float()
        dims = tuple(range(v.dim() - 1))
        mod.running_mean.copy_(v.mean(dims))
        mod.running_var.copy_(v.var(dims, unbiased=False))

    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, BatchNorm)]
    with torch.no_grad():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()


def clip_batch():
    """Host uint8 features and the preprocessed bf16 batch on the card:
    the first 8 of the synthetic clips the serve runs see."""
    import torch
    from picklebot_tpu_torch.data.dataset import ClipDataset, pad_collate
    from picklebot_tpu_torch.train.step import preprocess
    ds = ClipDataset("", "", backend="synthetic",
                     synthetic_shape=(32, 224, 224), synthetic_len=16)
    feats, _ = pad_collate([ds[i][0] for i in range(8)], [0] * 8, 16, 128)
    return feats, preprocess(torch.from_numpy(feats).cuda(), torch.bfloat16)


def serve_run(cfg, model, counters):
    """picklebot_tpu_torch.serve.main on 16 synthetic clips at --batch 8
    from ``model``'s weights, with every launch counter set to 0 just
    before it and read just after. Checks the predictions; returns the
    launches and the wall time."""
    import torch
    from picklebot_tpu_torch import serve
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        pth = os.path.join(tmp, "weights.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)
        for c in counters.values():
            c.update(dict.fromkeys(c, 0))
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main([cfg_path, "--checkpoint", pth, "--csv",
                             "synthetic", "--limit", "16", "--batch", "8"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = {name: dict(c) for name, c in counters.items()}
    lines = [json.loads(l) for l in out.getvalue().splitlines()
             if l.startswith("{")]
    preds = [l for l in lines if "pred" in l]
    if rc != 0 or len(preds) != 16 or "evaluated" not in lines[-1]:
        raise AssertionError(f"serve: rc {rc}, {len(preds)} predictions, "
                             f"last line {lines[-1] if lines else None}")
    if not all(0 <= p["pred"] < 13 and 0 < p["confidence"] <= 1
               for p in preds):
        raise AssertionError(f"serve: bad prediction lines {preds}")
    return launches, serve_s, len(preds), lines[-1]


def logits_against_plain(name, got, ref):
    """Kernel-path logits against the plain path's, both on the card:
    max abs err within 5% of max|logit|, argmax equal wherever the plain
    top-2 margin exceeds twice that."""
    import torch
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite logits")
    err = (got - ref).abs().max().item()
    scale_ = ref.abs().max().item()
    tol = LOGIT_REL_TOL * scale_
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    argmax_ok = bool((got.argmax(-1) == ref.argmax(-1))[clear].all())
    if err > tol or not argmax_ok:
        raise AssertionError(f"{name} logits: max abs err {err} (tol {tol}),"
                             f" argmax agrees where clear: {argmax_ok}")
    return {"logits_max_abs_err": err, "logits_max_abs": scale_,
            "rel_tol": LOGIT_REL_TOL,
            "argmax_agree": int((got.argmax(-1) == ref.argmax(-1)).sum()),
            "argmax_clear": int(clear.sum())}


def throughput(model, feats, x):
    """predict() from a host uint8 batch to host logits, and the forward's
    device time with the kernels and on the plain path."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.step import make_predict_fn
    predict = make_predict_fn(model, DtypePolicy.bf16(), device="cuda")
    for _ in range(2):
        predict(feats)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        predict(feats)
    dt = time.perf_counter() - t0
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: model(x), reps=reps)
        plain_ms = time_ms(lambda: model(x, kernels=False), reps=reps)
    return {"batch": 8, "clip": [32, 224, 224],
            "predict_clips_per_s": 8 * reps / dt, "forward_ms": fwd_ms,
            "forward_plain_ms": plain_ms}


def phase_serve_large3d(gpu_line, feats, x):
    import torch
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    cfg = {"model_name": "MobileNetLarge3D", "num_classes": 13,
           "use_autocast": True, "data_backend": "synthetic",
           "synthetic_shape": [32, 224, 224], "t_bucket": 16,
           "max_frames": 128, "synthetic_len": 16}
    model = MobileNetLarge3D(13, seed=0).cuda().eval()
    calibrate_batchnorm(model, x)
    n_se = sum(b.use_se for b in model.bottlenecks())
    n_blocks = len(list(model.bottlenecks()))
    launches, serve_s, n_preds, evaluated = serve_run(
        cfg, model, {"fused": fb.LAUNCHES})
    launches = launches["fused"]
    want = {"pool": 2 * n_se, "main": 2 * n_blocks}
    if launches != want:
        raise AssertionError(f"serve: launches {launches}, want {want}")
    emit({"phase": "serve", "model": "MobileNetLarge3D",
          "predictions": n_preds, "evaluated": evaluated,
          "launches": launches, "serve_wall_s": serve_s})

    with torch.inference_mode():
        check = logits_against_plain("MobileNetLarge3D", model(x).float(),
                                     model(x, kernels=False).float())
    emit({"phase": "serve", "model": "MobileNetLarge3D", **check})
    result = {"phase": "serve", "model": "MobileNetLarge3D",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile("MobileNetLarge3D", model, x)
    return result


def bottleneck_inputs(model, x):
    """The (B, T, H, W, C) input shape of each of the model's bottlenecks
    in one plain forward."""
    import torch
    shapes = []
    handles = [b.register_forward_pre_hook(
        lambda mod, args: shapes.append(tuple(args[0].shape)))
        for b in model.bottlenecks()]
    with torch.inference_mode():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()
    return shapes


def phase_serve_mobilevit(gpu_line, feats, x):
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    from picklebot_tpu_torch.ops import flash_attention as fa
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    widths = MOBILEVIT_CONFIGS["s"]
    cfg = {"model_name": "MobileViT", "num_classes": 13, **widths,
           "attention_backend": "auto", "use_autocast": True,
           "data_backend": "synthetic", "synthetic_shape": [32, 224, 224],
           "t_bucket": 16, "max_frames": 128, "synthetic_len": 16}
    model = MobileViT(num_classes=13, seed=0, **widths).cuda().eval()
    calibrate_batchnorm(model, x)
    shapes = bottleneck_inputs(model, x)
    if shapes != [g[0] for g in VIT_GEOMETRIES]:
        raise AssertionError(f"MobileViT-s bottleneck inputs {shapes}, "
                             "not the geometries the kernels were held at")
    launches, serve_s, n_preds, evaluated = serve_run(
        cfg, model, {"fused": fb.LAUNCHES, "flash": fa.LAUNCHES})
    # 2 batches x (7 bottlenecks without SE; 2 stage-1 layers at N=784)
    want = {"fused": {"pool": 0, "main": 14},
            "flash": {"packed": 4, "heads": 0}}
    if launches != want:
        raise AssertionError(f"MobileViT serve: launches {launches}, "
                             f"want {want}")
    emit({"phase": "serve", "model": "MobileViT-s", "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "serve_wall_s": serve_s})

    with torch.inference_mode():
        ref = model(x, kernels=False).float()
        check = logits_against_plain("MobileViT-s", model(x).float(), ref)
    emit({"phase": "serve", "model": "MobileViT-s", **check})
    result = {"phase": "serve", "model": "MobileViT-s",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile("MobileViT-s", model, x)
    for backend in ("pallas", "pallas_packed"):
        result[backend] = backend_forward(backend, model, x, ref)
    return result


def backend_forward(backend, model, x, ref):
    """One MobileViT-s forward with ``model``'s weights and another
    attention backend, whose 9 layers all take the per-head kernel
    ('pallas': split heads; 'pallas_packed': the (..., N, 3, H, D) qkv
    view). Launch counts set to 0 just before it and read just after;
    logits against the plain path's ``ref``."""
    import torch
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    from picklebot_tpu_torch.ops import flash_attention as fa
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    other = MobileViT(num_classes=13, seed=0, attention_backend=backend,
                      **MOBILEVIT_CONFIGS["s"]).cuda().eval()
    other.load_state_dict(model.state_dict())
    fb.LAUNCHES.update(pool=0, main=0)
    fa.LAUNCHES.update(packed=0, heads=0)
    with torch.inference_mode():
        got = other(x).float()
        torch.cuda.synchronize()
    launches = {"fused": dict(fb.LAUNCHES), "flash": dict(fa.LAUNCHES)}
    want = {"fused": {"pool": 0, "main": 7},
            "flash": {"packed": 0, "heads": 9}}
    if launches != want:
        raise AssertionError(f"MobileViT {backend} forward: launches "
                             f"{launches}, want {want}")
    check = logits_against_plain(f"MobileViT-s {backend}", got, ref)
    with torch.inference_mode():
        fwd_ms = time_ms(lambda: other(x), reps=10)
    emit({"phase": backend, "model": "MobileViT-s", "launches": launches,
          "forward_ms": fwd_ms, **check})
    return {"launches": launches, "forward_ms": fwd_ms, **check}


def warm_profiler():
    """Run torch.profiler once on a trivial op: its one-time start-up
    takes seconds, and paid here it overlaps the kernel build instead of
    the first trace. Returns the seconds it took."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def phase_profile(name, model, x):
    """Where one forward's device time goes: a torch.profiler trace of one
    bs-8 forward (kernels on) after a warm-up, with device time summed by
    kernel class (the port's two kernels by name, the rest by name too)
    and the device's busy and idle share between the forward's first and
    last kernel. A trace that holds no device events fails the run: the
    idle share and the device times are read from it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_start = time.perf_counter()
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"profile {name}: the trace holds no device "
                             "events")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    classes = {"flash_attention": ("fwd_kernel<",),
               "fused_bottleneck": ("main_kernel<", "pool_kernel<")}
    by_class = {c: sum(t for n, t in by_name.items()
                       if any(p in n for p in pats))
                for c, pats in classes.items()}
    out = {"phase": "profile", "model": name, "wall_ms": wall_ms,
           "kernel_window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / window,
           "kernel_launches": len(kernels),
           "by_class_ms": {c: t / 1e3 for c, t in by_class.items()},
           "other_ms": (sum(by_name.values()) - sum(by_class.values()))
           / 1e3,
           "top_kernels_ms": [[n[:120], t / 1e3] for n, t in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:12]],
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


def fused_entry(name, line, per, vit_per, launches_by_run):
    """Summary entry of one fused-bottleneck kernel: ms, plain, bound and
    library times summed over one bs-8 forward of each model."""
    def sums(r):
        if not r:
            return None
        return {"ms": sum(v["ms"] for v in r),
                "plain_ms": sum(v["plain_ms"] for v in r),
                "bound_ms": sum(v["bound_ms"] for v in r),
                "bound_by": ("bytes" if sum(v["bytes_ms"] for v in r)
                             >= sum(v["ops_ms"] for v in r)
                             else "operations"),
                "library_ms": sum(v["library_ms"] for v in r),
                "geometries": len(r)}
    large, vit = sums(per[name]), sums(vit_per[name])
    return {
        "name": f"fused_bottleneck_{name}", "route": "cuda",
        "source": "picklebot_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": f"picklebot_tpu/ops/pallas/fused_bottleneck.py:{line}",
        "launches": sum(r[name] for r in launches_by_run.values()),
        "launches_by_run": {k: r[name] for k, r in launches_by_run.items()},
        "max_abs_err": max(v["err"] for v in per[name] + vit_per[name]),
        **{k: large[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
        "per_forward": {"MobileNetLarge3D": large, "MobileViT-s": vit}}


def flash_entry(name, kernel, line, rows, launches_by_run, per_forward):
    """Summary entry of one flash entry point: times summed over the
    launches of one bs-8 MobileViT-s forward that takes it
    (``per_forward``: {N: launches})."""
    nolse = [r for r in rows if r["entry"] == kernel and not r["lse"]]
    by_n = {r["n"]: r for r in nolse}

    def total(key):
        return sum(by_n[n][key] * cnt for n, cnt in per_forward.items())
    out = {"name": name, "route": "cuda",
           "source": "picklebot_tpu_torch/csrc/flash_attention.cu",
           "replaces": line,
           "launches": sum(r[kernel] for r in launches_by_run.values()),
           "launches_by_run": {k: r[kernel]
                               for k, r in launches_by_run.items()},
           "max_abs_err": max(r["err"] for r in rows
                              if r["kernel"] == kernel),
           **{k: total(k) for k in ("ms", "plain_ms", "bound_ms",
                                    "library_ms")},
           "bound_by": ("bytes" if total("bytes_ms") >= total("ops_ms")
                        else "operations"),
           "per_forward": {str(n): c for n, c in per_forward.items()}}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the "
              "port on an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from picklebot_tpu_torch.utils.build import build_all

    gpu_line = nvidia_smi_line()
    print(gpu_line, flush=True)
    emit({"phase": "device", "nvidia_smi": gpu_line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count()})

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        build = pool.submit(build_all)
        warm_s = warm_profiler()
        libs = build.result()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "profiler_warmup_seconds": warm_s, "libraries": sorted(libs)})
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), file=sys.stderr)

    seconds = {"build": time.perf_counter() - t0,
               "profiler_warmup": warm_s}
    t0 = time.perf_counter()
    rows, per, vit_per, flash = phase_kernels()
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats, x = clip_batch()
    large = phase_serve_large3d(gpu_line, feats, x)
    seconds["serve_large3d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    vit = phase_serve_mobilevit(gpu_line, feats, x)
    seconds["serve_mobilevit"] = time.perf_counter() - t0
    seconds["profile_large3d"] = large["profile"]["seconds"]
    seconds["profile_mobilevit"] = vit["profile"]["seconds"]
    seconds["total"] = time.perf_counter() - T_START
    emit({"phase": "seconds", **seconds})

    # launches of each main-path run, read just after it
    runs = {"serve_large3d": large["launches"],
            "serve_mobilevit": vit["launches"]["fused"],
            **{f"forward_mobilevit_{b}": vit[b]["launches"]["fused"]
               for b in ("pallas", "pallas_packed")}}
    flash_runs = {"serve_mobilevit": vit["launches"]["flash"],
                  **{f"forward_mobilevit_{b}": vit[b]["launches"]["flash"]
                     for b in ("pallas", "pallas_packed")}}
    tpu = "picklebot_tpu/ops/pallas/"
    stage1 = VIT_ATTENTION[0][0]
    kernels = [
        fused_entry("pool", 86, per, vit_per, runs),
        fused_entry("main", 103, per, vit_per, runs),
        flash_entry("flash_packed_fwd", "packed",
                    f"{tpu}flash_packed.py:122", flash, flash_runs,
                    {stage1: VIT_ATTENTION[0][1]}),
        flash_entry("flash_fwd", "heads", f"{tpu}flash_attention.py:47",
                    flash, flash_runs, dict(VIT_ATTENTION)),
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": gpu_line, "seconds": seconds,
                   "geometries": rows, "flash": flash,
                   "serve": {"MobileNetLarge3D": large, "MobileViT-s": vit},
                   "kernels": kernels}, f, indent=1)
    print(gpu_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
