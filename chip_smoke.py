#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py                     # every phase
    python3 chip_smoke.py --only fused         # the fused kernels' rows
    python3 chip_smoke.py --only conv          # the conv kernel's rows
    python3 chip_smoke.py --only flash         # the flash kernels' rows
    python3 chip_smoke.py --only kernels serve # or any of kernels, fused,
                                               # conv, flash, serve, train,
                                               # timing

Phases, in order (each prints JSON lines; any failure exits non-zero; a
run with --only says on a JSON line which phases it skipped and prints no
kernels summary):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds every kernel from picklebot_tpu_torch/csrc/
              (fused_bottleneck, flash_attention, folded_conv), one process
              per source, all started together; meanwhile the profiler's
              one-time start-up runs on a trivial op
  3. kernels  each kernel against its plain PyTorch version on the card:
              the fused bottleneck at the 15 MobileNetLarge3D, the 7
              MobileViT-s and the 11 MobileNetSmall3D bottleneck geometries
              of a bs-8, 32x224x224 clip batch (bf16; each with its plan,
              two more calls bit-equal, device times from a trace and the
              SM clock; a split launch also against the plain version of
              its order), plus one f32 case with TF32 off; the flash
              forward kernel, packed without lse
              at MobileViT-s's three stages' shapes and with lse at stage
              1, per head at the three and at N=100, qkv-packed at stage 1
              (bf16; each with its plan, device times from a trace, the SM
              clock, TFLOP/s and two more calls bit-equal), f32 cases
              with TF32 off, and head dims 32 and 64; the fused
              kernels at batches past a grid's 65,535 y blocks (fb_main
              with B*T' = 67,200, fb_pool with B = 65,600); the flash
              backward kernels (dQ, dK/dV) against flash_backward_reference
              at the same shapes (with device times from a trace, the D
              pass, TFLOP/s, and two more calls bit-equal); the conv
              kernel, forward and dx, at
              MobileViT-s's six conv1/conv4 geometries (bf16; the plan each
              takes, stage 1 unsplit and stage 3 split over taps), at
              MobileViT-xxs's widths and the per-axis kernel sizes (1,3,3),
              (3,3,1), (1,5,3) (bf16 and f32), and in f32 with TF32 off at
              stage 2; kernel, plain and library times by CUDA events,
              bounds, TFLOP/s; the HMMA count of the SASS (cuobjdump) of
              the fused, conv and flash libraries and their ptxas
              registers, stack frames and spills (0 HMMA, a spill or a
              stack frame in a bf16 fused pool or main, conv, flash
              forward, dQ or dK/dV function fails the run; the others are
              reported);
              and 'auto''s threshold swept: at N = 32 ... 784 the
              head-packed kernel against the plain sdpa route, forward and
              forward + backward, by CUDA events and device time, and the
              smallest N from which the kernel route wins
  4. serve    picklebot_tpu_torch.serve.main on 16 synthetic clips at full
              width from a seeded .pth, for MobileNetLarge3D, MobileViT-s
              ('auto' attention), MobileNetSmall3D and MoViNet-A2: checks
              the predictions, the exact kernel launches of each run
              (every count set to 0 just before it, read just after; none
              for MoViNet-A2, which runs no hand-written kernel), and one
              batch's logits against the plain path on the card; then the
              predict throughput at bs 8, the forward's device time (for
              MobileViT-s also with conv1/conv4 on the library conv, as
              before the conv kernel, and at each of 'auto''s threshold
              routes), and a torch.profiler trace of one
              forward (device time by kernel, idle share; a trace without
              device events fails the run)
  5. pallas   one MobileViT-s forward each with attention_backend
              'pallas' and 'pallas_packed': 9 per-head flash launches
              each, logits against the plain path
  6. train    python -m picklebot_tpu_torch.cli on synthetic configs
              derived from configs/mobilevit_s.json,
              mobilenet_large_50k.json, mobilenet_small_50k.json and
              movinet_a2_50k.json (full width; each cut on a JSON line:
              32x224x224 synthetic clips, batch 8, 2 microbatches, 3
              steps, 48 clips): finite losses, the exact kernel launches
              of each run (the flash backward and the conv dx kernels
              included), and the written .pth serves; one MobileViT-s
              train step each with 'pallas' and 'pallas_packed'; every
              parameter's gradient against the plain path (kernels=False)
              on one bs-8 batch of MobileViT-s and MobileNetLarge3D; train
              step time, samples/s, forward and backward split, peak
              memory, and a torch.profiler trace of one train step per
              model (MobileViT-s also with conv1/conv4 on the library
              conv, and at each of 'auto''s threshold routes)
  7. summary  {"kernels": [...]}, the card line, and last
              {"ok": true, "device": ...}
Per-shape numbers also go to chiprun_out/chip_smoke.json. Without CUDA it
exits with code 2 and prints no result. Imports nothing of JAX.
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
# MobileNetSmall3D's 11 bottlenecks at the same input (E = 16, 72, 88 and
# 120 are no multiples of the kernels' 32-channel chunk)
SMALL_GEOMETRIES = [
    ((8, 16, 112, 112, 16), 3, 2, True, 16, 16),
    ((8, 9, 56, 56, 16), 3, 2, False, 72, 24),
    ((8, 6, 28, 28, 24), 3, 1, False, 88, 24),
    ((8, 8, 28, 28, 24), 5, 2, True, 96, 40),
    ((8, 6, 14, 14, 40), 5, 1, True, 240, 40),
    ((8, 10, 14, 14, 40), 5, 1, True, 240, 40),
    ((8, 14, 14, 14, 40), 5, 1, True, 120, 48),
    ((8, 18, 14, 14, 48), 5, 1, True, 144, 48),
    ((8, 22, 14, 14, 48), 5, 2, True, 288, 96),
    ((8, 13, 7, 7, 96), 5, 1, True, 576, 96),
    ((8, 17, 7, 7, 96), 5, 1, True, 576, 96),
]
# MobileViT-s attention at bs 8: 64 sequences (8 clips x 8 patch
# positions) of N tokens, 8 heads of 16, per stage: (N, layers)
VIT_ATTENTION = [(784, 2), (147, 4), (32, 3)]
VIT_SEQS, VIT_HEADS, VIT_DHEAD = 64, 8, 16
# the layers of those that 'auto' sends to the head-packed kernel (N at
# least the port's _PACKED_MIN_SEQ), per stage N; every exact flash launch
# count of a MobileViT-s run follows from it, and the run fails if the
# port's threshold routes otherwise
VIT_PACKED = {784: 2, 147: 4, 32: 3}
# 'auto''s threshold: N swept for it on the card, and the thresholds of
# MobileViT-s's four routes (no stage, stage 1, stages 1-2, every stage on
# the packed kernel), timed in turns in the serve and timing phases; 512
# is the JAX package's (a TPU measurement)
SWEEP_N = (32, 64, 147, 256, 512, 784)
PACKED_MIN_SEQ_TURNS = (785, 512, 147, 32)
# MobileViT-s's dense stride-1 3x3x3 convs at the same input, per stage:
# the MobileViTBlock's activation (B, T, H, W) and channel width C; conv1
# is C -> C on it, conv4 2C -> C. The serve phase checks that the model
# gives them these shapes.
VIT_CONV_STAGES = [((8, 8, 28, 28), 96), ((8, 5, 14, 14), 128),
                   ((8, 4, 7, 7), 160)]
# (x shape, Co, kernel): MobileViT-xxs's widths at bs 8 (48, 64, 80; conv4
# of its middle stage), then the per-axis kernel sizes of the JAX
# package's test of this kernel
CONV_EXTRA_CASES = [
    ((8, 8, 28, 28, 48), 48, (3, 3, 3)), ((8, 5, 14, 14, 128), 64, (3, 3, 3)),
    ((8, 4, 7, 7, 80), 80, (3, 3, 3)), ((2, 3, 4, 4, 64), 32, (1, 3, 3)),
    ((1, 5, 4, 3, 32), 32, (3, 3, 1)), ((1, 3, 5, 4, 32), 32, (1, 5, 3)),
    ((1, 4, 6, 5, 32), 48, (3, 3, 3))]
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
# The conv kernel in bf16 is held to both bounds as well: it and its plain
# version (cuDNN) accumulate in f32 and round once, so they differ by one
# bf16 ulp of a few outputs (measured rms ratio ~0.02%).
BF16_RMS_TOL = 1e-2
# f32 with TF32 off: the same f32 chain summed in another order.
F32_REL_TOL = 1e-4
FLASH_F32_REL_TOL = 2e-4     # online softmax against one softmax, f32
LSE_ABS_TOL = 1e-3           # f32 logsumexp of f32 scores, two orders
# logits after 15 blocks in bf16: the two paths' roundings random-walk
# through about 45 ops, sqrt(45) * 2^-9 ~ 1.3%; allow 5% of max|logit|.
LOGIT_REL_TOL = 5e-2
# train: a bs-8 step's loss and every parameter's gradient, kernel path
# against the plain path. In f32 with TF32 off both paths compute the same
# function (the fused bottleneck's backward is the plain chain's,
# recomputed; the flash backward is the plain backward's algebra), so every
# leaf is held to 1% rms and a cosine of 0.9999 (run 4B: worst 0.32%, in a
# Large3D SE layer behind 15 train-mode BatchNorms; MobileViT-s 2e-5). In
# bf16 the gradients themselves are far from f32: run 4B measured the plain
# path's bf16 gradients 43% (rms, the median leaf of Large3D) and 9%
# (MobileViT-s) from the f32 ones, up to 150% on a few leaves, so no bound
# of 5% between two bf16 paths can hold. There each leaf's kernel-path
# gradient must be no farther from the f32 gradient than twice the plain
# path's distance plus 5% (run 4B: at most 1.67 times), and the losses
# agree within 2%. A leaf whose gradient is zero in exact arithmetic (a
# bias straight before a train-mode BatchNorm) or negligible carries
# rounding noise only: a plain f32 gradient below 1% of the median leaf's
# rms marks one, and its f32 kernel-vs-plain difference must stay below
# that floor.
TRAIN_LOSS_REL_TOL = 2e-2
F32_LOSS_REL_TOL = 1e-4
GRAD_F32_RMS_TOL = 1e-2
GRAD_F32_MIN_COS = 0.9999
GRAD_BF16_FACTOR, GRAD_BF16_SLACK = 2.0, 5e-2
GRAD_NOISE_FLOOR = 1e-2
# the train phase's cuts of the repo's configs (full width)
TRAIN_CUTS = {"data_backend": "synthetic", "synthetic_shape": [32, 224, 224],
              "batch_size": 8, "effective_batch_size": 16,
              "synthetic_len": 48}
TRAIN_STEPS = 3
# what --only can pick; with no --only every phase runs
PHASES = ("kernels", "fused", "conv", "flash", "serve", "train", "timing")


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sm_clocks():
    """The card's SM clock now and its maximum (MHz), as nvidia-smi reads
    them: device times move with the clock, so rows carry it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    now, top = out.stdout.strip().splitlines()[0].split(",")
    return {"sm_mhz": int(now), "sm_max_mhz": int(top)}


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


def median_ms(fn, reps, runs=5):
    """The median of ``runs`` ``time_ms`` readings: a call whose event
    time is the host's moves from reading to reading."""
    return sorted(time_ms(fn, reps) for _ in range(runs))[runs // 2]


def device_ms(fn, reps=5, tries=3):
    """Mean device time (ms) per call of the kernels ``fn`` launches, from
    a torch.profiler trace of ``reps`` calls after one warm-up call: their
    own time, without the gaps that host work leaves between launches. A
    trace can come back without device events (one on an H100 did), so up
    to ``tries`` traces are taken; None if none held any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            return sum(spans) / 1e3 / reps
    return None


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
    flops = 4 * s * h * n * n * d
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


def flash_bwd_bound(s, h, n, d, elem, which):
    """Least time for the flash backward: 'dq' reads q, k, v, dO, lse and
    D and writes dq, 6*N^2*D FLOPs per head (S, dP, dQ); 'dkv' the same
    reads, dk and dv written, 8*N^2*D (S, dP, dV, dK); 'pair' the whole
    function, q, k, v, dO read and dq, dk, dv written, S, dP, dV, dQ and
    dK once: 10*N^2*D."""
    tensors, flops = {"dq": (5, 6), "dkv": (6, 8), "pair": (7, 10)}[which]
    nbytes = tensors * s * h * n * d * elem + 2 * s * h * n * 4
    flops *= s * h * n * n * d
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


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
    geometry (bf16): the check, the plan, two more calls bit-equal, kernel,
    plain and cuDNN-chain times by CUDA events, the kernel's device time
    from a trace and the SM clock after it. A split launch is also held
    against the plain version of its order (``pool_split_reference``, f32
    with TF32 off, to F32_REL_TOL: the same f32 values summed in another
    order; ``main_split_reference`` to the bf16 flash bounds)."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    def timed(name, fn, plain, lib, plan, extra):
        first, second = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(first, second):
            raise AssertionError(f"{name}: two calls differ")
        return dict(extra, plan=plan._asdict(), bit_equal_repeat=True,
                    ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps),
                    library_ms=time_ms(lib, reps),
                    device_ms=device_ms(fn, reps),
                    clocks_after_trace=sm_clocks())

    rows, per = [], {"pool": [], "main": []}
    for i, (shape, k, s, se, e, co) in enumerate(geometries):
        x, w = make_case(shape, k, e, co, torch.bfloat16, seed=seed0 + i)
        b, t, h, wd_, c = shape
        to, ho, wo = fb.out_shape(t, h, wd_, k, s)
        row = {"model": model, "block": i, "x": list(shape), "k": k,
               "s": s, "se": se, "E": e, "out": [b, to, ho, wo, co]}
        if se:
            name = f"{model} pool block {i}"
            plan = fb._pool_plan(tuple(shape), k, s, e, x.dtype)
            want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
            got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
            torch.cuda.synchronize()
            err, ref = check_close(name, got, want, BF16_REL_TOL)
            extra = {}
            if plan.splits > 1:
                with DtypePolicy.f32().precision():
                    split_want = fb.pool_split_reference(x, w["w1"],
                                                         w["wd"], k, s, plan)
                extra["err_vs_split_plain"] = check_close(
                    f"{name} (split plain)", got, split_want,
                    F32_REL_TOL)[0]
            per["pool"].append(dict(err=err, **bound(
                shape, k, s, e, co, 2, "pool"), **timed(
                name, lambda: fb.fused_pool(x, w["w1"], w["wd"], k, s),
                lambda: fb.pool_reference(x, w["w1"], w["wd"], k, s),
                lambda: library_chain(x, w, k, s, None, False), plan,
                extra)))
            row["pool"] = dict(per["pool"][-1], max_ref=ref)
            scale = fb.se_scale(want / float(to * ho * wo), w["se_w1"],
                                w["se_b1"], w["se_w2"], w["se_b2"],
                                x.dtype)
        else:
            scale = torch.ones((b, e), device="cuda")
        name = f"{model} main block {i}"
        plan = fb._main_plan(tuple(shape), k, s, e, co, x.dtype)
        want = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        got = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
        torch.cuda.synchronize()
        if tuple(got.shape) != (b, to, ho, wo, co):
            raise AssertionError(f"{name}: shape {got.shape}")
        err, ref = check_close(name, got, want, BF16_REL_TOL)
        extra = {}
        if plan.splits > 1:
            with DtypePolicy.f32().precision():
                split_want = fb.main_split_reference(
                    x, w["w1"], w["wd"], w["w2"], scale, k, s, plan.splits)
            extra["vs_split_plain"] = check_bf16_flash(
                f"{name} (split plain)", got, split_want)
        per["main"].append(dict(err=err, **bound(
            shape, k, s, e, co, 2, "main"), **timed(
            name, lambda: fb.fused_main(x, w["w1"], w["wd"], w["w2"],
                                        scale, k, s),
            lambda: fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale,
                                      k, s),
            lambda: library_chain(x, w, k, s, scale, True), plan, extra)))
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
    """The flash forward kernel against its plain versions at MobileViT-s's
    shapes (bf16): packed without lse at every stage (N=147 and 32 ragged)
    and with lse at stage 1, per head at every stage and at N=100 (a
    ragged tile inside a warp's rows), qkv-packed at stage 1. Each row:
    the check, two more calls bit-equal, the plan, kernel, plain and SDPA
    times by CUDA events, kernel and SDPA device times from a trace (at
    N=147 and 32 a call's host work outlasts its kernel), the SM clock
    after the traces, TFLOP/s on the 4*N^2*D FLOPs per head, and the
    ratios to bound and SDPA. Then f32 with TF32 off (packed with lse at
    stage 1, per head and qkv-packed at N=147, the last key tile ragged),
    and per head at head dims 32 and 64 (bf16). Rows carry the entry
    point and the ``LAUNCHES`` key it counts under."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    scale = d ** -0.5
    rows = []

    def sdpa_lib(q4, k4, v4):      # yardstick only; the port never calls it
        return F.scaled_dot_product_attention(q4, k4, v4, scale=scale)

    def heads_of(qkv5):            # (S, N, 3, H, D) -> q, k, v (S, H, N, D)
        return [qkv5.select(-3, i).transpose(-2, -3) for i in range(3)]

    def held(row, fn, plain, lib, with_lse):
        """Check one bf16 case against its plain version, then time it."""
        name = f"flash {row['entry']} bf16 n={row['n']}" + (
            " (lse)" if with_lse else "")
        got, want = fn(), plain()
        torch.cuda.synchronize()
        if with_lse:
            row["lse_err"] = check_close(f"{name} lse", got[1], want[1],
                                         0.0, LSE_ABS_TOL)[0]
            got, want = got[0], want[0]
        if got.shape != want.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)}")
        row.update(check_bf16_flash(name, got, want))
        first, second = fn(), fn()
        torch.cuda.synchronize()
        row["bit_equal_repeat"] = all(
            torch.equal(a, b) for a, b in zip(
                first if with_lse else [first],
                second if with_lse else [second]))
        if not row["bit_equal_repeat"]:
            raise AssertionError(f"{name}: two calls differ")
        n = row["n"]
        row.update(flash_bound(VIT_SEQS, h, n, d, 2, with_lse),
                   plan=fa._forward_plan((VIT_SEQS, h, n, d),
                                         torch.bfloat16)._asdict(),
                   ms=time_ms(fn, reps), plain_ms=time_ms(plain, reps),
                   library_ms=time_ms(lib, reps),
                   device_ms=device_ms(fn, reps),
                   library_device_ms=device_ms(lib, reps),
                   clocks_after_traces=sm_clocks())
        for pre in ("", "device_"):
            t, t_lib = row[f"{pre}ms"], row[f"library_{pre}ms"]
            row[f"{pre}tflops"] = (None if t is None
                                   else row["flops"] / t / 1e9)
            row[f"{pre}x_bound"] = None if t is None else t / row["bound_ms"]
            row[f"{pre}x_library"] = (None if t is None or t_lib is None
                                      else t / t_lib)
        emit({"phase": "kernels", "flash": "fwd", **row})
        rows.append(row)

    # packed, bf16: without lse at every stage, with lse at stage 1
    for n, with_lse in [(n_, False) for n_, _ in VIT_ATTENTION] + [
            (VIT_ATTENTION[0][0], True)]:
        q, k, v = seeded_qkv(n, torch.bfloat16, seed=200 + n).chunk(3, -1)
        split = [fa.split_heads(t, h) for t in (q, k, v)]
        held({"entry": "packed", "kernel": "packed", "n": n,
              "dtype": "bfloat16", "lse": with_lse},
             lambda: fa.flash_attention_packed(q, k, v, h,
                                               with_lse=with_lse),
             lambda: fa.flash_attention_packed_reference(
                 q, k, v, h, with_lse=with_lse),
             lambda: sdpa_lib(*split), with_lse)
        del q, k, v, split

    # per head, every stage and N=100, bf16, on the split heads' views
    for n in sorted({n_ for n_, _ in VIT_ATTENTION} | {100}, reverse=True):
        split = [fa.split_heads(t, h) for t in seeded_qkv(
            n, torch.bfloat16, seed=300 + n).chunk(3, dim=-1)]
        held({"entry": "heads", "kernel": "heads", "n": n,
              "dtype": "bfloat16", "lse": False},
             lambda: fa.flash_attention(*split),
             lambda: fa.flash_attention_reference(*split),
             lambda: sdpa_lib(*split), False)
        del split

    # qkv-packed ('pallas_packed'), stage 1, bf16: q, k, v read in place
    # from the (64, N, 3, H, D) view of one projection output
    n = VIT_ATTENTION[0][0]
    qkv5 = seeded_qkv(n, torch.bfloat16, seed=350).unflatten(-1, (3, h, d))
    if tuple(fa.flash_attention_qkvpacked(qkv5).shape) != (VIT_SEQS, n, h,
                                                           d):
        raise AssertionError("flash qkv-packed: output shape")
    held({"entry": "qkvpacked", "kernel": "heads", "n": n,
          "dtype": "bfloat16", "lse": False},
         lambda: fa.flash_attention_qkvpacked(qkv5),
         lambda: fa.flash_attention_qkvpacked_reference(qkv5),
         lambda: sdpa_lib(*heads_of(qkv5)), False)
    del qkv5

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


def packed_route_sweep(reps):
    """'auto''s two routes at each N of SWEEP_N (64 sequences x 8 heads x
    16, bf16, q, k and v the chunks of one qkv projection output, as
    MultiHeadAttention hands them on): the head-packed kernel
    (``flash_attention_packed``) against the plain route (``sdpa`` on split
    heads, merged), the forward alone and forward + backward
    (``FlashPackedFn`` against autograd through ``sdpa``), each by CUDA
    events and by device time from a trace. The two routes' outputs are
    held against each other at the flash bf16 bound; their input grads'
    distance is reported. Event times are the median of five readings
    (at small N they are the host's). The pick: the smallest swept N from
    which the kernel route is faster in all four times, at that N and at
    every larger one (None if at none)."""
    import torch
    from picklebot_tpu_torch.ops import attention
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    scale = d ** -0.5
    rows = []
    for n in SWEEP_N:
        qkv = seeded_qkv(n, torch.bfloat16, seed=900 + n)
        g = torch.randn(VIT_SEQS, n, h * d, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(
                            901 + n)).to(torch.bfloat16)
        leaf = qkv.detach().requires_grad_()

        def kernel_route(t):
            return fa.flash_attention_packed(*t.chunk(3, dim=-1), h, scale)

        def sdpa_route(t):
            q, k, v = (fa.split_heads(x, h) for x in t.chunk(3, dim=-1))
            return fa.merge_heads(fa.sdpa(q, k, v, scale))

        def fwd_bwd(route):
            return lambda: torch.autograd.grad(route(leaf), leaf, g)[0]
        calls = {"kernel_fwd": lambda: kernel_route(qkv),
                 "sdpa_fwd": lambda: sdpa_route(qkv),
                 "kernel_fwd_bwd": fwd_bwd(kernel_route),
                 "sdpa_fwd_bwd": fwd_bwd(sdpa_route)}
        row = {"n": n, "out": check_bf16_flash(
            f"sweep n={n} packed kernel against sdpa route",
            calls["kernel_fwd"](), calls["sdpa_fwd"]())}
        dq_k, dq_s = calls["kernel_fwd_bwd"](), calls["sdpa_fwd_bwd"]()
        row["grad_rms_err_over_rms"] = ((dq_k.float() - dq_s.float()).pow(
            2).mean().sqrt() / dq_s.float().pow(2).mean().sqrt()).item()
        for name, fn in calls.items():
            row[f"ms_{name}"] = median_ms(fn, reps)
            row[f"device_ms_{name}"] = device_ms(fn, reps)
        times = [(row[f"{pre}ms_kernel_{w}"], row[f"{pre}ms_sdpa_{w}"])
                 for pre in ("", "device_") for w in ("fwd", "fwd_bwd")]
        row["kernel_faster"] = all(None not in t and t[0] < t[1]
                                   for t in times)
        emit({"phase": "kernels", "sweep": "packed_min_seq", **row})
        rows.append(row)
        del qkv, g, leaf, dq_k, dq_s
    pick = None
    for row in reversed(rows):
        if not row["kernel_faster"]:
            break
        pick = row["n"]
    out = {"phase": "kernels", "sweep": "packed_min_seq", "n": list(SWEEP_N),
           "pick": pick, "port_packed_min_seq": attention._PACKED_MIN_SEQ,
           "clocks": sm_clocks()}
    emit(out)
    return dict(out, rows=rows)


def flash_bwd_case(layout, n, dtype, seed, dh=VIT_DHEAD):
    """One flash backward case on MobileViT-s's stage shapes: seeded
    q, k, v (views of one qkv projection) and output gradient, the
    Function's grads (forward kernel with lse, D, dQ and dK/dV kernels;
    ``run`` computes them again), the plain backward's from the same
    forward residuals, and, but for qkv-packed, per-kernel launchers on
    the kernels' (S, H, N, D) views, the D pass and the kernels' plan, for
    timing."""
    import torch
    from picklebot_tpu_torch.ops import flash_attention as fa
    h, scale = VIT_HEADS * VIT_DHEAD // dh, dh ** -0.5
    qkv = seeded_qkv(n, dtype, seed).requires_grad_()
    g = torch.randn(VIT_SEQS, n, h * dh, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed + 1)).to(dtype)
    if layout == "qkvpacked":
        qkv5 = qkv.unflatten(-1, (3, h, dh))
        g5 = g.unflatten(-1, (h, dh))

        def run():
            return [t.transpose(-2, -3) for t in torch.autograd.grad(
                fa.flash_attention_qkvpacked(qkv5), qkv5, g5)[0].unbind(-3)]
        q, k, v = fa._qkv_split(qkv5.detach())
        out, lse = fa._qkvpacked_forward(qkv5.detach(), scale, True)
        want = fa.flash_backward_reference(q, k, v, out.transpose(-2, -3),
                                           lse, g5.transpose(-2, -3), scale)
        return dict(got=run(), want=want, run=run)
    q, k, v = qkv.chunk(3, dim=-1)
    if layout == "packed":
        def run():
            return [fa.split_heads(t, h) for t in torch.autograd.grad(
                fa.flash_attention_packed(q, k, v, h), (q, k, v), g)]
        with torch.no_grad():
            out, lse = fa.flash_attention_packed(q, k, v, h, with_lse=True)
    else:
        q, k, v = (fa.split_heads(t, h) for t in (q, k, v))
        g = fa.split_heads(g, h)

        def run():
            return torch.autograd.grad(fa.flash_attention(q, k, v),
                                       (q, k, v), g)
        with torch.no_grad():
            out, lse = fa._heads_forward(q, k, v, scale, True)
    heads = [fa.split_heads(t, h) if layout == "packed" else t
             for t in (q.detach(), k.detach(), v.detach(), out, g)]
    want = fa.flash_backward_reference(*heads[:4], lse, heads[4], scale)
    # the kernels' own views, D and output buffers, for the timed launches
    bufs = [torch.empty_like(t) for t in heads[:3]]
    q4, k4, v4, o4, g4, *out4 = (fa._as_seq_head(t) for t in heads + bufs)
    lse3 = lse.reshape(q4.shape[:3])
    dd = fa._backward_d(o4, g4)

    def launch(name):
        fa._launch_backward_kernel(name, q4, k4, v4, g4, lse3, dd, *out4,
                                   scale)
    return dict(got=run(), want=want, run=run, launch=launch, heads=heads,
                lse=lse, d_pass=lambda: fa._backward_d(o4, g4),
                plan=fa._backward_plan(q4.shape, q4.dtype))


def bitwise_repeatable(c):
    """Two more backward calls of a case give gradients equal bit for bit
    to each other (no atomics: the order of every sum is fixed)."""
    import torch
    first, second = c["run"](), c["run"]()
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(first, second))


def flash_bwd_rows(reps):
    """The flash backward kernels against ``flash_backward_reference`` at
    MobileViT-s's attention shapes: packed at the stages 'auto' sends to
    the packed kernel (VIT_PACKED) and per head at every stage (bf16, with
    the plan, dQ, dK/dV and D-pass times by CUDA events and from a trace,
    plain and library times, TFLOP/s against the
    pair's bound, and two more calls bit-equal), qkv-packed at stage 1
    (bf16, bit-equal too), f32 with TF32 off (packed at stage 1, per head
    at N=147, a ragged last tile), head dims 32 and 64 (bf16, per head,
    N=147). Library: autograd through F.scaled_dot_product_attention on
    the same tensors, its backward alone, set against D + dQ + dK/dV."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import flash_attention as fa

    h, d = VIT_HEADS, VIT_DHEAD
    rows = []

    def held(name, got, want, f32=False):
        out = {}
        for part, a, b in zip(("dq", "dk", "dv"), got, want):
            if f32:
                out[part] = dict(err=check_close(
                    f"{name} {part}", a, b, FLASH_F32_REL_TOL)[0])
            else:
                out[part] = check_bf16_flash(f"{name} {part}", a, b)
        torch.cuda.synchronize()
        return out

    for layout, n, seed in [("packed", n_, 600 + n_) for n_ in VIT_PACKED] + [
            ("heads", n_, 610 + n_) for n_, _ in VIT_ATTENTION]:
        c = flash_bwd_case(layout, n, torch.bfloat16, seed)
        errs = held(f"flash bwd {layout} bf16 n={n}", c["got"], c["want"])
        q, k, v, o, g = c["heads"]
        lib_in = [t.detach().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*lib_in, scale=d ** -0.5)

        def lib_backward():
            torch.autograd.grad(lib_out, lib_in, g, retain_graph=True)
        calls = {"dq": lambda: c["launch"]("dq"),
                 "dkv": lambda: c["launch"]("dkv"), "d": c["d_pass"]}
        row = {"entry": layout, "n": n, "dtype": "bfloat16", **errs,
               "err": max(e["err"] for e in errs.values()),
               "plan": c["plan"]._asdict(),
               "bit_equal_repeat": bitwise_repeatable(c),
               **{f"ms_{k_}": time_ms(f, reps) for k_, f in calls.items()},
               "plain_ms": time_ms(lambda: fa.flash_backward_reference(
                   q, k, v, o, c["lse"], g, d ** -0.5), reps),
               "library_ms": time_ms(lib_backward, reps),
               **{f"device_ms_{k_}": device_ms(f, reps)
                  for k_, f in calls.items()},
               "library_device_ms": device_ms(lib_backward, reps),
               "clocks_after_traces": sm_clocks()}
        if not row["bit_equal_repeat"]:
            raise AssertionError(f"flash bwd {layout} n={n}: two backward "
                                 "calls differ")
        for which in ("dq", "dkv", "pair"):
            row[f"bound_{which}"] = flash_bwd_bound(VIT_SEQS, h, n, d, 2,
                                                    which)
        # the whole backward (D pass, dQ, dK/dV) against SDPA's, and the
        # pair's rate on the function's 10*N^2*D FLOPs per head
        for pre in ("", "device_"):
            parts = [row[f"{pre}ms_{k_}"] for k_ in calls]
            lib = row[f"library_{pre}ms"]
            whole = None if None in parts else sum(parts)
            pair = None if None in parts else parts[0] + parts[1]
            row[f"{pre}ms_backward"] = whole
            row[f"{pre}x_library"] = (None if whole is None or lib is None
                                      else whole / lib)
            row[f"{pre}tflops_pair"] = (
                None if pair is None
                else row["bound_pair"]["flops"] / pair / 1e9)
            row[f"{pre}x_bound_pair"] = (
                None if pair is None
                else pair / row["bound_pair"]["bound_ms"])
        emit({"phase": "kernels", "kernel": "flash_bwd", **row})
        rows.append(row)
        del c, q, k, v, o, g, lib_in, lib_out

    c = flash_bwd_case("qkvpacked", VIT_ATTENTION[0][0], torch.bfloat16,
                       650)
    qkv_errs = held("flash bwd qkv-packed bf16 n=784", c["got"], c["want"])
    if not bitwise_repeatable(c):
        raise AssertionError("flash bwd qkv-packed: two backward calls "
                             "differ")
    f32 = {}
    with DtypePolicy.f32().precision():
        for layout, n in (("packed", VIT_ATTENTION[0][0]), ("heads", 147)):
            c = flash_bwd_case(layout, n, torch.float32, 660)
            f32[f"{layout} n={n}"] = held(f"flash bwd {layout} f32 n={n}",
                                          c["got"], c["want"], f32=True)
    dims = {}
    for dh in (32, 64):
        c = flash_bwd_case("heads", 147, torch.bfloat16, 670 + dh, dh=dh)
        dims[f"d={dh}"] = held(f"flash bwd per-head bf16 d={dh}", c["got"],
                               c["want"])
    emit({"phase": "kernels", "kernel": "flash_bwd",
          "qkvpacked n=784 bf16": qkv_errs, "f32": f32,
          "rel_tol_f32": FLASH_F32_REL_TOL, "head_dims": dims})
    return rows


def conv_bound(shape, co, kernel, elem):
    """Least time for the stride-1 same-padded dense conv: x and w read
    and the output written once; 2*Ci*Co FLOPs per output position and
    tap that stays inside the clip (a tap in the zero padding needs no
    arithmetic, so the count is this geometry's, not 27 per position)."""
    b, t, h, w, ci = shape

    def inside(n, k):
        return sum(max(0, n - abs(d - (k - 1) // 2)) for d in range(k))
    taps_inside = b * inside(t, kernel[0]) * inside(h, kernel[1]) * inside(
        w, kernel[2])
    m = b * t * h * w
    nbytes = (m * (ci + co) + kernel[0] * kernel[1] * kernel[2] * ci * co
              ) * elem
    flops = 2 * taps_inside * ci * co
    return dict(roofline(nbytes, flops, "bfloat16" if elem == 2
                         else "float32"), flops=flops)


def conv_case(shape, co, kernel, dtype, seed):
    """Seeded x, w (Kt, Kh, Kw, Ci, Co) and output gradient on the card, w
    scaled U(-1/sqrt(fan_in), 1/sqrt(fan_in)); the flipped weight and the
    library's weight layout for the yardstick calls."""
    import torch
    g_ = torch.Generator(device="cuda").manual_seed(seed)
    ci = shape[-1]
    bound_ = (ci * kernel[0] * kernel[1] * kernel[2]) ** -0.5
    x = torch.randn(*shape, generator=g_, device="cuda").to(dtype)
    w = ((torch.rand(*kernel, ci, co, generator=g_, device="cuda") * 2 - 1)
         * bound_).to(dtype)
    g = torch.randn(*shape[:-1], co, generator=g_, device="cuda").to(dtype)
    pads = tuple(((k - 1) // 2,) * 2 for k in kernel)
    w_flip = w.flip(0, 1, 2).transpose(-1, -2).contiguous()
    w_lib = w.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    return x, w, g, pads, w_flip, w_lib


def conv_rows(reps):
    """The conv kernel against its plain version on the card, forward and
    dx: MobileViT-s's six conv1/conv4 geometries (bf16, with the plan each
    launch takes, kernel, plain and library times, bounds, achieved
    TFLOP/s and the ratios to bound and library; kernel and library
    device times from a trace too, since at stages 2 and 3 a call's host
    work outlasts its kernels), MobileViT-xxs's widths
    and the JAX test's per-axis kernel sizes (bf16 and f32), and one f32
    case at stage 2 with TF32 off. Stage 1's forward runs unsplit and
    stage 3's split over taps (both checked here); a split case is also
    held against ``folded_conv_split_reference``, the plain version of the
    split's order. Plain: ``folded_conv_reference`` (forward; for dx on
    the output gradient with the flipped weight). Library, timed as a
    yardstick only: ``F.conv3d`` on the channels_last_3d view with the
    weight in cuDNN's layout, and ``torch.nn.grad.conv3d_input`` for dx
    (its result is also held against the kernel's)."""
    import torch
    import torch.nn.functional as F
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops import folded_conv as fc

    def plans(shape, co, kernel):
        m, taps = shape[0] * shape[1] * shape[2] * shape[3], (
            kernel[0] * kernel[1] * kernel[2])
        return fc._plan(m, co, taps), fc._plan(m, shape[-1], taps)

    def held(name, shape, co, kernel, dtype, seed):
        x, w, g, pads, w_flip, w_lib = conv_case(shape, co, kernel, dtype,
                                                 seed)
        assert fc.folded_conv_s1_eligible(x.shape, w.shape, (1, 1, 1), pads)
        xr = x.detach().requires_grad_()
        out = fc.folded_conv_s1(xr, w, pads)
        dx, = torch.autograd.grad(out, xr, g)
        want = fc.folded_conv_reference(x, w, pads)
        want_dx = fc.folded_conv_reference(g, w_flip, pads)
        lib_dx = torch.nn.grad.conv3d_input(
            x.permute(0, 4, 1, 2, 3).shape, w_lib, g.permute(0, 4, 1, 2, 3),
            padding=tuple(p[0] for p in pads)).permute(0, 2, 3, 4, 1)
        torch.cuda.synchronize()
        if out.shape != want.shape or dx.shape != x.shape:
            raise AssertionError(f"{name}: shapes {tuple(out.shape)}, "
                                 f"{tuple(dx.shape)}")
        if dtype == torch.bfloat16:
            errs = {"fwd": check_bf16_flash(f"{name} fwd", out, want),
                    "dx": check_bf16_flash(f"{name} dx", dx, want_dx),
                    "dx_vs_library": check_bf16_flash(f"{name} dx (library)",
                                                     dx, lib_dx)}
            plan = plans(shape, co, kernel)[0]
            if plan.splits > 1:
                errs["fwd_vs_split_plain"] = check_bf16_flash(
                    f"{name} fwd (split plain)", out,
                    fc.folded_conv_split_reference(x, w, pads, plan.splits))
        else:
            errs = {"fwd": dict(err=check_close(f"{name} fwd", out, want,
                                                F32_REL_TOL)[0]),
                    "dx": dict(err=check_close(f"{name} dx", dx, want_dx,
                                               F32_REL_TOL)[0]),
                    "dx_vs_library": dict(err=check_close(
                        f"{name} dx (library)", dx, lib_dx, F32_REL_TOL)[0])}
        return errs, (x, w, g, pads, w_flip, w_lib)

    rows = []
    for stage, ((b, t, h, w_), c) in enumerate(VIT_CONV_STAGES, 1):
        for conv, ci in (("conv1", c), ("conv4", 2 * c)):
            shape, kernel = (b, t, h, w_, ci), (3, 3, 3)
            name = f"conv stage {stage} {conv} bf16"
            plan_fwd, plan_dx = plans(shape, c, kernel)
            if (stage == 1) != (plan_fwd.splits == 1):
                raise AssertionError(f"{name}: plan {plan_fwd}; stage 1 "
                                     "must run unsplit, stage 3 split")
            errs, (x, w, g, pads, w_flip, w_lib) = held(
                name, shape, c, kernel, torch.bfloat16, 700 + 10 * stage + ci)
            xc, gc = x.permute(0, 4, 1, 2, 3), g.permute(0, 4, 1, 2, 3)
            row = {"stage": stage, "conv": conv, "x": list(shape), "Co": c,
                   "k": list(kernel), "dtype": "bfloat16", **errs,
                   "plan_fwd": plan_fwd._asdict(),
                   "plan_dx": plan_dx._asdict(),
                   "fwd_bound": conv_bound(shape, c, kernel, 2),
                   "dx_bound": conv_bound(shape[:-1] + (c,), ci, kernel, 2),
                   "ms_fwd": time_ms(lambda: fc._conv(x, w, pads, "fwd"),
                                     reps),
                   "ms_dx": time_ms(lambda: fc._conv(g, w_flip, pads, "dx"),
                                    reps),
                   "plain_ms_fwd": time_ms(
                       lambda: fc.folded_conv_reference(x, w, pads), reps),
                   "plain_ms_dx": time_ms(
                       lambda: fc.folded_conv_reference(g, w_flip, pads),
                       reps),
                   "library_ms_fwd": time_ms(
                       lambda: F.conv3d(xc, w_lib, padding=1), reps),
                   "library_ms_dx": time_ms(
                       lambda: torch.nn.grad.conv3d_input(
                           xc.shape, w_lib, gc, padding=1), reps)}
            row.update(
                device_ms_fwd=device_ms(lambda: fc._conv(x, w, pads, "fwd"),
                                        reps),
                device_ms_dx=device_ms(lambda: fc._conv(g, w_flip, pads,
                                                        "dx"), reps),
                library_device_ms_fwd=device_ms(
                    lambda: F.conv3d(xc, w_lib, padding=1), reps),
                library_device_ms_dx=device_ms(
                    lambda: torch.nn.grad.conv3d_input(xc.shape, w_lib, gc,
                                                       padding=1), reps))
            for which in ("fwd", "dx"):
                ms, bnd = row[f"ms_{which}"], row[f"{which}_bound"]
                row[f"tflops_{which}"] = bnd["flops"] / ms / 1e9
                row[f"x_bound_{which}"] = ms / bnd["bound_ms"]
                row[f"x_library_{which}"] = ms / row[f"library_ms_{which}"]
                dev = row[f"device_ms_{which}"]
                row[f"device_tflops_{which}"] = (
                    None if dev is None else bnd["flops"] / dev / 1e9)
            emit({"phase": "kernels", "kernel": "folded_conv", **row})
            rows.append(row)
            del x, w, g, w_flip, w_lib, xc, gc
    extra = {}
    for i, (shape, co, kernel) in enumerate(CONV_EXTRA_CASES):
        key = f"{list(shape)}->{co} k{list(kernel)}"
        extra[key] = {"bf16": held(f"conv {key} bf16", shape, co, kernel,
                                   torch.bfloat16, 800 + i)[0],
                      "plan_fwd": plans(shape, co, kernel)[0]._asdict()}
        with DtypePolicy.f32().precision():
            extra[key]["f32"] = held(f"conv {key} f32", shape, co, kernel,
                                     torch.float32, 850 + i)[0]
    with DtypePolicy.f32().precision():
        (b, t, h, w_), c = VIT_CONV_STAGES[1]
        f32 = {conv: held(f"conv stage 2 {conv} f32", (b, t, h, w_, ci), c,
                          (3, 3, 3), torch.float32, 900 + ci)[0]
               for conv, ci in (("conv1", c), ("conv4", 2 * c))}
    emit({"phase": "kernels", "kernel": "folded_conv", "f32_stage_2": f32,
          "rel_tol_f32": F32_REL_TOL, "bf16_rel_tol": BF16_REL_TOL,
          "bf16_rms_tol": BF16_RMS_TOL, "other_widths_and_kernels": extra})
    return rows


def sass_check(lib_path, kernel, must):
    """Tensor cores and registers of one built library: the count of HMMA
    instructions in each function's SASS (``cuobjdump -sass``), and
    ptxas's registers, stack frame and spill bytes for each from the build
    log. Fails if a function whose name holds one of ``must`` (the bf16
    ones) has no HMMA, spills or keeps a stack frame (an array indexed at
    run time lives in local memory without counting as a spill), or if
    there is none; the others are reported only."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = found.group(1)
            hmma[name] = 0
        elif name and "HMMA" in line:
            hmma[name] += 1
    ptxas, name = {}, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        found = re.search(r"Compiling entry function '(\S+)'", line)
        if found:
            name = found.group(1)
            ptxas[name] = {}
        spills = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", line)
        if name and spills:
            ptxas[name].update(stack_frame=int(spills.group(1)),
                               spill_stores=int(spills.group(2)),
                               spill_loads=int(spills.group(3)))
        regs = re.search(r"Used (\d+) registers", line)
        if name and regs:
            ptxas[name]["registers"] = int(regs.group(1))
    funcs = {n: dict(hmma=c, **ptxas.get(n, {})) for n, c in hmma.items()}
    checked = {n: v for n, v in funcs.items() if any(m in n for m in must)}
    emit({"phase": "kernels", "kernel": kernel, "sass": funcs})
    if not checked or any(v["hmma"] == 0 or v.get("spill_stores", 1)
                          or v.get("spill_loads", 1)
                          or v.get("stack_frame", 1)
                          for v in checked.values()):
        raise AssertionError(f"{kernel} functions {checked}: each needs HMMA "
                             "instructions, no spills and no stack frame "
                             "(local memory)")
    return funcs


def fused_large_batch_cases():
    """The fused kernels at batches past the 65,535 of a grid's y axis:
    fb_main with B*T' = 2,100 x 32 = 67,200 frames and fb_pool with B =
    65,600 samples, small frames (4x4, k 3, stride 1, C 16, E 32, bf16),
    each against its plain version."""
    import torch
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    k, s, e, co = 3, 1, 32, 16
    res = {}
    x, w = make_case((2100, 30, 4, 4, 16), k, e, co, torch.bfloat16, 150)
    scale = torch.rand((x.shape[0], e), device="cuda", generator=(
        torch.Generator(device="cuda").manual_seed(151)))
    got = fb.fused_main(x, w["w1"], w["wd"], w["w2"], scale, k, s)
    want = fb.main_reference(x, w["w1"], w["wd"], w["w2"], scale, k, s)
    torch.cuda.synchronize()
    if got.shape[0] * got.shape[1] <= 65535:
        raise AssertionError(f"fb_main large batch: output {got.shape}")
    res["main"] = dict(x=list(x.shape), frames=got.shape[0] * got.shape[1],
                       err=check_close("fb_main B*T' > 65535", got, want,
                                       BF16_REL_TOL)[0])
    del x, w, scale, got, want
    x, w = make_case((65600, 1, 4, 4, 16), k, e, co, torch.bfloat16, 152)
    got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
    want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
    torch.cuda.synchronize()
    res["pool"] = dict(x=list(x.shape), err=check_close(
        "fb_pool B > 65535", got, want, BF16_REL_TOL)[0])
    emit({"phase": "kernels", "large_batch_case": res,
          "rel_tol": BF16_REL_TOL})
    return res


def phase_kernels():
    return (*fused_phase(), *flash_phase(), conv_rows(reps=5))


def fused_phase():
    """The fused rows of the three models that run the fused kernels, the
    f32 case and the large-batch cases."""
    rows, fused_per = [], {}
    for model, geometries, seed0 in (
            ("MobileNetLarge3D", GEOMETRIES, 0),
            ("MobileViT-s", VIT_GEOMETRIES, 50),
            ("MobileNetSmall3D", SMALL_GEOMETRIES, 70)):
        model_rows, fused_per[model] = fused_rows(model, geometries, seed0,
                                                  reps=5)
        rows += model_rows
    fused_f32_case()
    return rows, fused_per, fused_large_batch_cases()


def flash_phase():
    """The flash forward and backward rows, then 'auto''s sweep."""
    return (flash_rows(reps=5), flash_bwd_rows(reps=5),
            packed_route_sweep(reps=10))


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


def all_counters():
    """The launch counts of every kernel module, by module."""
    from picklebot_tpu_torch.ops import flash_attention as fa
    from picklebot_tpu_torch.ops import folded_conv as fc
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    return {"fused": fb.LAUNCHES, "flash": fa.LAUNCHES, "conv": fc.LAUNCHES}


def launches_wanted(**by_module):
    """Every kernel's wanted count: those named, and 0 for every other."""
    return {name: {k: by_module.get(name, {}).get(k, 0) for k in c}
            for name, c in all_counters().items()}


@contextlib.contextmanager
def conv_on_library():
    """Within the block every ``Conv3d`` keeps to ``F.conv3d``: MobileViT's
    conv1/conv4 as they ran before the conv kernel was wired in, the
    other kernels still on. For before-and-after timings inside one run;
    the port has no such switch."""
    from picklebot_tpu_torch.ops.conv import Conv3d
    saved = Conv3d.takes_folded_kernel
    Conv3d.takes_folded_kernel = lambda self, x: False
    try:
        yield
    finally:
        Conv3d.takes_folded_kernel = saved


@contextlib.contextmanager
def packed_min_seq(n):
    """Within the block 'auto' sends sequences of at least ``n`` tokens to
    the head-packed kernel (the port's ``_PACKED_MIN_SEQ`` patched): to
    time MobileViT-s at each of the threshold's routes inside one run; the
    port has no such switch."""
    from picklebot_tpu_torch.ops import attention
    saved = attention._PACKED_MIN_SEQ
    attention._PACKED_MIN_SEQ = n
    try:
        yield
    finally:
        attention._PACKED_MIN_SEQ = saved


def by_packed_min_seq(measure):
    """``measure()`` at each threshold of PACKED_MIN_SEQ_TURNS in turn,
    then once more at the port's own."""
    out = {}
    for n in PACKED_MIN_SEQ_TURNS:
        with packed_min_seq(n):
            out[str(n)] = measure()
    out["port_again"] = measure()
    return out


def zero_counters(counters):
    """Set every launch count to 0 (just before a main-path run)."""
    for c in counters.values():
        c.update(dict.fromkeys(c, 0))


def read_counters(counters):
    return {name: dict(c) for name, c in counters.items()}


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
        zero_counters(counters)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main([cfg_path, "--checkpoint", pth, "--csv",
                             "synthetic", "--limit", "16", "--batch", "8"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = read_counters(counters)
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


def plain_logits(name, model, x):
    """f32 logits of the plain path (``kernels=False``) on the card, which
    must launch no hand-written kernel."""
    import torch
    counters = all_counters()
    zero_counters(counters)
    with torch.inference_mode():
        ref = model(x, kernels=False).float()
    torch.cuda.synchronize()
    if read_counters(counters) != launches_wanted():
        raise AssertionError(f"{name} plain path (kernels=False) launched "
                             f"{read_counters(counters)}")
    return ref


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
        with conv_on_library():
            conv_lib_ms = time_ms(lambda: model(x), reps=reps)
        fwd_ms2 = time_ms(lambda: model(x), reps=reps)
    return {"batch": 8, "clip": [32, 224, 224],
            "predict_clips_per_s": 8 * reps / dt, "forward_ms": fwd_ms,
            "forward_plain_ms": plain_ms,
            "forward_ms_conv_on_library": conv_lib_ms,
            "forward_ms_again": fwd_ms2}


def serve_config(model_name, **extra):
    return {"model_name": model_name, "num_classes": 13,
            "use_autocast": True, "data_backend": "synthetic",
            "synthetic_shape": [32, 224, 224], "t_bucket": 16,
            "max_frames": 128, "synthetic_len": 16, **extra}


def phase_serve_mobilenet(name, make_model, geometries, gpu_line, feats, x):
    """MobileNetLarge3D or MobileNetSmall3D: every bottleneck on the fused
    kernels (the pool pass in the SE blocks), no other kernel."""
    import torch

    model = make_model().cuda().eval()
    calibrate_batchnorm(model, x)
    shapes = bottleneck_inputs(model, x)
    if shapes != [g[0] for g in geometries]:
        raise AssertionError(f"{name} bottleneck inputs {shapes}, not the "
                             "geometries the kernels were held at")
    n_se = sum(b.use_se for b in model.bottlenecks())
    n_blocks = len(list(model.bottlenecks()))
    launches, serve_s, n_preds, evaluated = serve_run(
        serve_config(name), model, all_counters())
    want = launches_wanted(fused={"pool": 2 * n_se, "main": 2 * n_blocks})
    if launches != want:
        raise AssertionError(f"serve {name}: launches {launches}, want "
                             f"{want}")
    launches = launches["fused"]
    emit({"phase": "serve", "model": name, "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "serve_wall_s": serve_s})

    with torch.inference_mode():
        check = logits_against_plain(name, model(x).float(),
                                     plain_logits(name, model, x))
    emit({"phase": "serve", "model": name, **check})
    result = {"phase": "serve", "model": name,
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile(name, model, x)
    return result


def phase_serve_movinet(gpu_line, feats, x):
    """MoViNet-A2 (offline): matmuls and cuDNN depthwise convs only, so
    the run must launch no hand-written kernel; its logits are held to be
    finite and of the right shape, its predictions checked by
    ``serve_run``."""
    import torch

    model = movinet_a2().cuda().eval()
    calibrate_batchnorm(model, x)
    launches, serve_s, n_preds, evaluated = serve_run(
        serve_config("MoViNetA2"), model, all_counters())
    if launches != launches_wanted():
        raise AssertionError(f"serve MoViNetA2: launches {launches}, want "
                             "none")
    with torch.inference_mode():
        logits = model(x).float()
    if tuple(logits.shape) != (8, 13) or not torch.isfinite(logits).all():
        raise AssertionError(f"MoViNetA2 logits: shape {tuple(logits.shape)}"
                             ", or not finite")
    emit({"phase": "serve", "model": "MoViNetA2", "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "logits_max_abs": logits.abs().max().item(),
          "serve_wall_s": serve_s})
    result = {"phase": "serve", "model": "MoViNetA2",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    emit(result)
    result["profile"] = phase_profile("MoViNetA2", model, x)
    return result


def conv_kernel_inputs(model, x):
    """(input shape, Co) of every conv that takes the conv kernel, in one
    plain forward."""
    import torch
    from picklebot_tpu_torch.ops.conv import Conv3d
    seen = []

    def hook(mod, args):
        if mod.takes_folded_kernel(args[0]):
            seen.append((tuple(args[0].shape), mod.out_channels))
    handles = [m.register_forward_pre_hook(hook) for m in model.modules()
               if isinstance(m, Conv3d)]
    with torch.inference_mode():
        model(x, kernels=False)
    for hnd in handles:
        hnd.remove()
    return seen


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
    widths = MOBILEVIT_CONFIGS["s"]
    cfg = serve_config("MobileViT", **widths, attention_backend="auto")
    model = MobileViT(num_classes=13, seed=0, **widths).cuda().eval()
    calibrate_batchnorm(model, x)
    shapes = bottleneck_inputs(model, x)
    if shapes != [g[0] for g in VIT_GEOMETRIES]:
        raise AssertionError(f"MobileViT-s bottleneck inputs {shapes}, "
                             "not the geometries the kernels were held at")
    convs = conv_kernel_inputs(model, x)
    want_convs = [(dims + (ci,), c) for dims, c in VIT_CONV_STAGES
                  for ci in (c, 2 * c)]
    if convs != want_convs:
        raise AssertionError(f"MobileViT-s conv1/conv4 inputs {convs}, not "
                             f"the geometries the kernel was held at")
    launches, serve_s, n_preds, evaluated = serve_run(cfg, model,
                                                      all_counters())
    # 2 batches x (7 bottlenecks without SE; the VIT_PACKED attention
    # layers; conv1 and conv4 of 3 blocks)
    want = launches_wanted(fused={"main": 14},
                           flash={"packed": 2 * sum(VIT_PACKED.values())},
                           conv={"fwd": 12})
    if launches != want:
        raise AssertionError(f"MobileViT serve: launches {launches}, "
                             f"want {want}")
    emit({"phase": "serve", "model": "MobileViT-s", "predictions": n_preds,
          "evaluated": evaluated, "launches": launches,
          "serve_wall_s": serve_s})

    ref = plain_logits("MobileViT-s", model, x)
    with torch.inference_mode():
        check = logits_against_plain("MobileViT-s", model(x).float(), ref)
    emit({"phase": "serve", "model": "MobileViT-s", **check})
    result = {"phase": "serve", "model": "MobileViT-s",
              **throughput(model, feats, x), "card": gpu_line,
              "launches": launches}
    with torch.inference_mode():
        result["forward_ms_by_packed_min_seq"] = by_packed_min_seq(
            lambda: time_ms(lambda: model(x), reps=10))
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

    other = MobileViT(num_classes=13, seed=0, attention_backend=backend,
                      **MOBILEVIT_CONFIGS["s"]).cuda().eval()
    other.load_state_dict(model.state_dict())
    counters = all_counters()
    zero_counters(counters)
    with torch.inference_mode():
        got = other(x).float()
        torch.cuda.synchronize()
    launches = read_counters(counters)
    want = launches_wanted(fused={"main": 7}, flash={"heads": 9},
                           conv={"fwd": 6})
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
    """Where one bs-8 forward's device time goes (kernels on)."""
    import torch

    def forward():
        with torch.inference_mode():
            model(x)
    return profile_run(name, forward, "profile")


def union_us(spans):
    """Length of the union of (start, end) spans."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return total if cur_e is None else total + cur_e - cur_s


def profile_run(name, fn, phase):
    """A torch.profiler trace of one call of ``fn`` after a warm-up call,
    with device time summed by kernel class (the port's kernels by name,
    the rest by name too) and the device's busy and idle share between
    the first and the last kernel. A trace that holds no device events
    fails the run: the idle share and the device times are read from
    it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_start = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError(f"profile {name}: the trace holds no device "
                             "events")
    spans = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = union_us(spans)
    window = max(e for _, e in spans) - min(s for s, _ in spans)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    # cuDNN's generic grouped-conv weight gradient (the depthwise convs'
    # in the fused bottleneck's recompute backward) runs kernels that
    # overlap in time, so classes also get the union of their spans
    classes = {"flash_attention": ("fwd_bf16_kernel<", "fwd_f32_kernel<"),
               "flash_attention_bwd": ("dq_bf16_kernel<", "dkv_bf16_kernel<",
                                       "dq_f32_kernel<", "dkv_f32_kernel<"),
               "fused_bottleneck": ("main_bf16_kernel<", "pool_bf16_kernel<",
                                    "main_f32_kernel", "pool_f32_kernel",
                                    "main_split_sum_kernel",
                                    "pool_split_sum_kernel"),
               "folded_conv": ("conv_f32_kernel", "conv_bf16_kernel<",
                               "conv_split_sum_kernel"),
               "cudnn_grouped_wgrad": ("convolveNd_wgrad_engine<",)}
    by_class = {c: sum(t for n, t in by_name.items()
                       if any(p in n for p in pats))
                for c, pats in classes.items()}
    busy_by_class = {c: union_us([
        (e.time_range.start, e.time_range.end) for e in kernels
        if any(p in e.name for p in pats)]) / 1e3
        for c, pats in classes.items()}
    out = {"phase": phase, "model": name, "wall_ms": wall_ms,
           "kernel_window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
           "device_idle_share": 1 - busy / window,
           "kernel_launches": len(kernels),
           "by_class_ms": {c: t / 1e3 for c, t in by_class.items()},
           "busy_by_class_ms": busy_by_class,
           "other_ms": (sum(by_name.values()) - sum(by_class.values()))
           / 1e3,
           "top_kernels_ms": [[n[:120], t / 1e3] for n, t in sorted(
               by_name.items(), key=lambda kv: -kv[1])[:12]],
           "seconds": time.perf_counter() - t_start}
    emit(out)
    return out


# --------------------------------------------------------------------------
# train
# --------------------------------------------------------------------------

def phase_train_cli(label, cfg_file, counters, per_micro, per_eval):
    """``python -m picklebot_tpu_torch.cli`` (in process) on
    ``configs/<cfg_file>`` with TRAIN_CUTS, for TRAIN_STEPS steps, every
    launch count set to 0 just before and read just after: the counts
    must be exactly ``per_micro`` per train microbatch (forward and
    backward) plus ``per_eval`` per eval batch. Then the .pth it wrote
    serves 8 clips."""
    import math
    import torch
    from picklebot_tpu_torch import cli, serve

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(ROOT, "configs", cfg_file)) as f:
            cfg = json.load(f)
        reduced = {k: {"from": cfg.get(k), "to": v}
                   for k, v in TRAIN_CUTS.items() if cfg.get(k) != v}
        cfg.update(TRAIN_CUTS, checkpoint_dir=os.path.join(tmp, "ck"),
                   log_dir=os.path.join(tmp, "runs"))
        path = os.path.join(tmp, "cfg.json")
        with open(path, "w") as f:
            json.dump(cfg, f)
        emit({"phase": "train", "model": label,
              "config": f"configs/{cfg_file}", "width": "full",
              "reduced": reduced, "steps": {"from": None,
                                            "to": TRAIN_STEPS}})
        zero_counters(counters)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            summary = cli.main([path, "--steps", str(TRAIN_STEPS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters(counters)
        n_micro = TRAIN_STEPS * (TRAIN_CUTS["effective_batch_size"]
                                 // TRAIN_CUTS["batch_size"])
        n_eval = -(-TRAIN_CUTS["synthetic_len"] // TRAIN_CUTS["batch_size"])
        want = {c: {k: per_micro[c][k] * n_micro + per_eval[c][k] * n_eval
                    for k in per_micro[c]} for c in per_micro}
        if launches != want:
            raise AssertionError(f"train {label}: launches {launches}, "
                                 f"want {want}")
        losses = summary["train_losses"]
        if len(losses) != n_micro or not all(
                math.isfinite(v) for v in losses + [summary[
                    "final_val_loss"]]):
            raise AssertionError(f"train {label}: losses {losses}, val "
                                 f"{summary['final_val_loss']}")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = serve.main([path, "--checkpoint", summary["checkpoint"],
                             "--csv", "synthetic", "--limit", "8",
                             "--batch", "8"])
        preds = [json.loads(line) for line in out.getvalue().splitlines()
                 if line.startswith('{"clip"')]
        if rc != 0 or len(preds) != 8:
            raise AssertionError(f"train {label}: serving the .pth gave rc "
                                 f"{rc}, {len(preds)} predictions")
    res = {"phase": "train", "model": label, "launches": launches,
           "launches_per_microbatch": per_micro,
           "launches_per_eval_batch": per_eval, "microbatches": n_micro,
           "eval_batches": n_eval, "train_losses": losses,
           "val_loss": summary["final_val_loss"], "cli_wall_s": wall,
           "pth_served": len(preds), "seconds": time.perf_counter() - t_start}
    emit(res)
    return res


def mobilevit_s(backend="auto"):
    from picklebot_tpu_torch.models.mobilevit import (MOBILEVIT_CONFIGS,
                                                      MobileViT)
    return MobileViT(num_classes=13, seed=0, attention_backend=backend,
                     **MOBILEVIT_CONFIGS["s"])


def large3d():
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    return MobileNetLarge3D(13, seed=0)


def small3d():
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetSmall3D
    return MobileNetSmall3D(13, seed=0)


def movinet_a2():
    from picklebot_tpu_torch.models.movinet import MoViNetA2
    return MoViNetA2(13, seed=0)


def train_step_for(model):
    """The port's train step (AdamW8bit, bf16, constant lr) on the card."""
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.train.optim import AdamW8bit
    from picklebot_tpu_torch.train.step import make_train_step
    opt = AdamW8bit(model.parameters(), weight_decay=5e-4)
    return make_train_step(model, opt, "CE", lambda epoch: 3e-4,
                           DtypePolicy.bf16(), device="cuda"), opt


def phase_train_backends(counters, feats, labels):
    """One MobileViT-s train step (one bs-8 microbatch) each with
    'pallas' and 'pallas_packed': every layer's attention forward and
    backward on the per-head kernels, 9 launches each."""
    import math
    import torch
    out = {}
    want = launches_wanted(fused={"main": 7},
                           flash={"heads": 9, "dq": 9, "dkv": 9},
                           conv={"fwd": 6, "dx": 6})
    for backend in ("pallas", "pallas_packed"):
        step, _ = train_step_for(mobilevit_s(backend).cuda())
        zero_counters(counters)
        metrics = step(0, feats[None], labels[None])
        torch.cuda.synchronize()
        launches = read_counters(counters)
        loss = float(metrics["loss"][0])
        if launches != want or not math.isfinite(loss):
            raise AssertionError(f"train step {backend}: launches "
                                 f"{launches} (want {want}), loss {loss}")
        out[backend] = {"launches": launches, "loss": loss}
        emit({"phase": "train", "model": f"MobileViT-s {backend}",
              **out[backend]})
    return out


def grads_against_plain(label, make_model, x, labels):
    """One bs-8 train-mode step's loss and every parameter's gradient,
    kernel path against the plain path (kernels=False), from the same
    seeded weights, dropout p set to 0, in bf16 and in f32 with TF32 off;
    the bounds are stated with GRAD_F32_RMS_TOL above."""
    import torch
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.ops.linear import ChannelDropout, Dropout
    from picklebot_tpu_torch.train.losses import cross_entropy
    lbl = torch.as_tensor(labels, device="cuda")
    res = {}
    for dtype, policy in (("bf16", DtypePolicy.bf16()),
                          ("f32", DtypePolicy.f32())):
        for kernels in (True, False):
            m = make_model().cuda().train()
            for mod in m.modules():
                if isinstance(mod, (ChannelDropout, Dropout)):
                    mod.p = 0.0
            with policy.precision():
                loss = cross_entropy(m(x.to(policy.compute_dtype),
                                       kernels=kernels), lbl)
                loss.backward()
            res[dtype, kernels] = (loss.item(), {
                n: p.grad.float() for n, p in m.named_parameters()})
            del m, loss

    def rms(t):
        return t.pow(2).mean().sqrt().item()

    def cos(a, b):
        return torch.nn.functional.cosine_similarity(
            a.flatten(), b.flatten(), dim=0).item()

    bad = []
    for dtype, tol in (("bf16", TRAIN_LOSS_REL_TOL),
                       ("f32", F32_LOSS_REL_TOL)):
        got, want = res[dtype, True][0], res[dtype, False][0]
        if abs(got - want) > tol * abs(want):
            bad.append((f"{dtype} loss", got, want))
    truth, f32_k = res["f32", False][1], res["f32", True][1]
    bf16_k, bf16_p = res["bf16", True][1], res["bf16", False][1]
    scale = {n: rms(g) for n, g in truth.items()}
    floor = GRAD_NOISE_FLOOR * sorted(scale.values())[len(scale) // 2]
    stats, noise = {}, []
    for n, ref in truth.items():
        if scale[n] < floor:
            noise.append(n)
            if rms(f32_k[n] - ref) > floor:
                bad.append((n, "noise leaf", rms(f32_k[n] - ref)))
            continue
        st = stats[n] = dict(
            f32=rms(f32_k[n] - ref) / scale[n], f32_cos=cos(f32_k[n], ref),
            bf16=rms(bf16_k[n] - bf16_p[n]) / rms(bf16_p[n]),
            bf16_cos=cos(bf16_k[n], bf16_p[n]),
            kernel_vs_f32=rms(bf16_k[n] - ref) / scale[n],
            plain_vs_f32=rms(bf16_p[n] - ref) / scale[n])
        if (st["f32"] > GRAD_F32_RMS_TOL or st["f32_cos"] < GRAD_F32_MIN_COS
                or st["kernel_vs_f32"] > GRAD_BF16_FACTOR
                * st["plain_vs_f32"] + GRAD_BF16_SLACK):
            bad.append((n, st))
    worst = {k: max(v[k] for v in stats.values())
             for k in ("f32", "bf16", "kernel_vs_f32", "plain_vs_f32")}
    worst.update(f32_cos=min(v["f32_cos"] for v in stats.values()),
                 bf16_cos=min(v["bf16_cos"] for v in stats.values()),
                 kernel_over_plain_vs_f32=max(
                     v["kernel_vs_f32"] / v["plain_vs_f32"]
                     for v in stats.values()))
    median = {k: sorted(v[k] for v in stats.values())[len(stats) // 2]
              for k in ("kernel_vs_f32", "plain_vs_f32", "bf16")}
    out = {"phase": "train_grads", "model": label,
           "loss": {f"{d} {'kernels' if k else 'plain'}": v[0]
                    for (d, k), v in res.items()},
           "leaves": len(truth), "noise_leaves": noise,
           "noise_floor": floor, "worst": worst, "median": median}
    emit(out)
    if bad:
        raise AssertionError(f"{label} grads against plain: {bad[:6]}")
    return dict(out, per_leaf=stats)


def phase_train_timing(label, make_model, feats, x, labels, gpu_line,
                       vit_turns=False):
    """Train step (bs 8, one microbatch, uint8 host batch -> optimizer
    update) by host clock after a synchronize, samples/s, peak device
    memory over those steps; forward (train mode, with a graph),
    forward+backward and the optimizer update alone by CUDA events; a
    trace of one train step. ``vit_turns`` (MobileViT-s): the step,
    forward and backward once more with conv1/conv4 on the library conv
    (as before the conv kernel), then the step again with the kernel; and
    the step and forward+backward at each of 'auto''s threshold routes
    (``by_packed_min_seq``)."""
    import torch
    from picklebot_tpu_torch.ops.linear import dropout_rng
    from picklebot_tpu_torch.train.losses import cross_entropy
    t_start = time.perf_counter()
    model = make_model().cuda()
    step, opt = train_step_for(model)
    f, lb = feats[None], labels[None]
    for _ in range(2):
        step(0, f, lb)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reps = 5
    t0 = time.perf_counter()
    for _ in range(reps):
        step(0, f, lb)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak = torch.cuda.max_memory_allocated()

    def timed_steps():
        step(0, f, lb)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step(0, f, lb)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3
    lbl = torch.as_tensor(labels, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    model.train()

    def forward():
        with dropout_rng(gen):
            return cross_entropy(model(x), lbl)
    fwd_ms = time_ms(forward, reps)
    fwd_bwd_ms = time_ms(lambda: forward().backward(), reps)
    opt_ms = time_ms(lambda: opt.step(3e-4), reps)
    res = {"phase": "train_timing", "model": label, "batch": 8,
           "clip": [32, 224, 224], "dtype": "bfloat16",
           "optimizer": "adamw8bit", "train_step_ms": step_ms,
           "samples_per_s": 8e3 / step_ms, "forward_ms": fwd_ms,
           "backward_ms": fwd_bwd_ms - fwd_ms, "optimizer_ms": opt_ms,
           "peak_memory_bytes": peak, "card": gpu_line}
    if vit_turns:
        with conv_on_library():
            lib_fwd = time_ms(forward, reps)
            res["conv_on_library"] = {
                "train_step_ms": timed_steps(), "forward_ms": lib_fwd,
                "backward_ms": time_ms(lambda: forward().backward(), reps)
                - lib_fwd}
        res["train_step_ms_again"] = timed_steps()
        res["by_packed_min_seq"] = by_packed_min_seq(lambda: {
            "train_step_ms": timed_steps(),
            "forward_backward_ms": time_ms(lambda: forward().backward(),
                                           reps)})
    emit(res)
    res["profile"] = profile_run(f"{label} train step",
                                 lambda: step(0, f, lb), "train_profile")
    res["seconds"] = time.perf_counter() - t_start
    return res


def fused_entry(name, line, fused_per, launches_by_run):
    """Summary entry of one fused-bottleneck kernel: ms, plain, bound and
    library times summed over one bs-8 forward of each model (the top
    level: MobileNetLarge3D's)."""
    def sums(r):
        if not r:
            return None
        dev = [v["device_ms"] for v in r]
        return {"ms": sum(v["ms"] for v in r),
                "device_ms": None if None in dev else sum(dev),
                "plain_ms": sum(v["plain_ms"] for v in r),
                "bound_ms": sum(v["bound_ms"] for v in r),
                "bound_by": ("bytes" if sum(v["bytes_ms"] for v in r)
                             >= sum(v["ops_ms"] for v in r)
                             else "operations"),
                "library_ms": sum(v["library_ms"] for v in r),
                "geometries": len(r)}
    per_forward = {model: sums(per[name])
                   for model, per in fused_per.items()}
    large = per_forward["MobileNetLarge3D"]
    return {
        "name": f"fused_bottleneck_{name}", "route": "cuda",
        "source": "picklebot_tpu_torch/csrc/fused_bottleneck.cu",
        "replaces": f"picklebot_tpu/ops/pallas/fused_bottleneck.py:{line}",
        "launches": sum(r[name] for r in launches_by_run.values()),
        "launches_by_run": {k: r[name] for k, r in launches_by_run.items()},
        "max_abs_err": max(v["err"] for per in fused_per.values()
                           for v in per[name]),
        **{k: large[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "device_ms")},
        "per_forward": per_forward}


def conv_entry(which, rows, launches_by_run):
    """Summary entry of the conv kernel's forward or dx: times summed over
    the six launches of one bs-8 MobileViT-s forward (or one train
    microbatch's backward)."""
    def total(key):
        vals = [r[key] for r in rows]
        return None if None in vals else sum(vals)
    bounds = [r[f"{which}_bound"] for r in rows]
    return {"name": f"folded_conv_{which}", "route": "cuda",
            "source": "picklebot_tpu_torch/csrc/folded_conv.cu",
            "replaces": "picklebot_tpu/ops/pallas/folded_conv.py:58",
            "launches": sum(r[which] for r in launches_by_run.values()),
            "launches_by_run": {k: r[which]
                                for k, r in launches_by_run.items()},
            "max_abs_err": max(r[which]["err"] for r in rows),
            "ms": total(f"ms_{which}"),
            "plain_ms": total(f"plain_ms_{which}"),
            "bound_ms": sum(b["bound_ms"] for b in bounds),
            "bound_by": ("bytes" if sum(b["bytes_ms"] for b in bounds)
                         >= sum(b["ops_ms"] for b in bounds)
                         else "operations"),
            "library_ms": total(f"library_ms_{which}"),
            "device_ms": total(f"device_ms_{which}"),
            "library_device_ms": total(f"library_device_ms_{which}"),
            "per_forward" if which == "fwd" else "per_microbatch":
            {f"stage {r['stage']} {r['conv']}": 1 for r in rows}}


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
           **{k: (None if any(by_n[n][k] is None for n in per_forward)
                  else total(k))
              for k in ("device_ms", "library_device_ms")},
           "per_forward": {str(n): c for n, c in per_forward.items()}}
    return out


def flash_bwd_entry(name, kernel, line, rows, entry, launches_by_run,
                    per_step):
    """Summary entry of one flash backward kernel on one layout: times
    summed over the launches of one bs-8 MobileViT-s train microbatch that
    takes it (``per_step``: {N: launches}). The plain and library times
    are those of the whole backward (both kernels' work)."""
    by_n = {r["n"]: r for r in rows if r["entry"] == entry}

    def total(f):
        vals = [f(by_n[n]) for n in per_step]
        return None if None in vals else sum(
            v * c for v, c in zip(vals, per_step.values()))
    parts = ("dq",) if kernel == "dq" else ("dk", "dv")
    return {"name": name, "route": "cuda",
            "source": "picklebot_tpu_torch/csrc/flash_attention.cu",
            "replaces": line,
            "launches": sum(r[kernel] for r in launches_by_run.values()),
            "launches_by_run": {k: r[kernel]
                                for k, r in launches_by_run.items()},
            "max_abs_err": max(r[p]["err"] for r in by_n.values()
                               for p in parts),
            "ms": total(lambda r: r[f"ms_{kernel}"]),
            "plain_ms": total(lambda r: r["plain_ms"]),
            "bound_ms": total(lambda r: r[f"bound_{kernel}"]["bound_ms"]),
            "bound_by": ("bytes" if total(
                lambda r: r[f"bound_{kernel}"]["bytes_ms"]) >= total(
                lambda r: r[f"bound_{kernel}"]["ops_ms"])
                else "operations"),
            "library_ms": total(lambda r: r["library_ms"]),
            "device_ms": total(lambda r: r[f"device_ms_{kernel}"]),
            "library_device_ms": total(lambda r: r["library_device_ms"]),
            "plain_and_library_cover": "the whole backward",
            "per_microbatch": {str(n): c for n, c in per_step.items()}}


def parse_args(argv):
    import argparse
    ap = argparse.ArgumentParser(
        description="Run the PyTorch/CUDA port on one NVIDIA card and check "
        "it end to end.")
    ap.add_argument(
        "--only", nargs="+", choices=PHASES,
        help="run only these phases after the device and build phases: "
        "kernels (every kernel against its plain version), fused (the "
        "fused-bottleneck rows, the f32 and large-batch cases and the "
        "fused library's SASS check alone), conv (the conv "
        "kernel's rows alone), flash (the flash kernels' rows alone, "
        "forward and backward), serve, train (the CLI runs, the attention "
        "backends, the gradients against the plain path), timing (the "
        "train-step timings). A partial run prints no kernels summary")
    return ap.parse_args(argv)


def main(argv=None):
    import torch
    only = set(parse_args(argv).only or ())

    def selected(phase):
        return not only or phase in only

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
    from picklebot_tpu_torch.ops import attention
    routed = {n: layers for n, layers in VIT_ATTENTION
              if n >= attention._PACKED_MIN_SEQ}
    if routed != VIT_PACKED:
        raise AssertionError(f"'auto' at _PACKED_MIN_SEQ = "
                             f"{attention._PACKED_MIN_SEQ} sends {routed} "
                             f"to the packed kernel; VIT_PACKED says "
                             f"{VIT_PACKED}")
    rows = fused_per = large_batch = flash = flash_bwd = sweep = conv = None
    large = vit = small = movinet = None
    sass = {}
    t0 = time.perf_counter()
    if selected("kernels"):
        rows, fused_per, large_batch, flash, flash_bwd, sweep, conv = \
            phase_kernels()
    if "fused" in only and not selected("kernels"):
        rows, fused_per, large_batch = fused_phase()
    if "conv" in only and not selected("kernels"):
        conv = conv_rows(reps=5)
    if "flash" in only and not selected("kernels"):
        flash, flash_bwd, sweep = flash_phase()
    if selected("kernels") or "fused" in only:
        sass["fused_bottleneck"] = sass_check(
            libs["fused_bottleneck"], "fused_bottleneck",
            ("pool_bf16_kernel", "main_bf16_kernel"))
    if selected("kernels") or "conv" in only:
        sass["folded_conv"] = sass_check(libs["folded_conv"], "folded_conv",
                                         ("conv_bf16_kernel",))
    if selected("kernels") or "flash" in only:
        sass["flash_attention"] = sass_check(
            libs["flash_attention"], "flash_attention",
            ("fwd_bf16_kernel", "dq_bf16_kernel", "dkv_bf16_kernel"))
    if sass:
        seconds["kernels"] = time.perf_counter() - t0
    if selected("serve") or selected("train") or selected("timing"):
        feats, x = clip_batch()
    if selected("serve"):
        t0 = time.perf_counter()
        large = phase_serve_mobilenet("MobileNetLarge3D", large3d,
                                      GEOMETRIES, gpu_line, feats, x)
        seconds["serve_large3d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        vit = phase_serve_mobilevit(gpu_line, feats, x)
        seconds["serve_mobilevit"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        small = phase_serve_mobilenet("MobileNetSmall3D", small3d,
                                      SMALL_GEOMETRIES, gpu_line, feats, x)
        seconds["serve_small3d"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        movinet = phase_serve_movinet(gpu_line, feats, x)
        seconds["serve_movinet"] = time.perf_counter() - t0
        for key, res in (("large3d", large), ("mobilevit", vit),
                         ("small3d", small), ("movinet", movinet)):
            seconds[f"profile_{key}"] = res["profile"]["seconds"]

    import numpy as np
    counters = all_counters()
    labels = np.arange(8) % 13
    train = {}
    if selected("train"):
        # per train microbatch (forward and backward) and per eval batch
        packed = sum(VIT_PACKED.values())
        cli_runs = [
            ("MobileViT-s", "mobilevit_s.json",
             launches_wanted(fused={"main": 7},
                             flash={"packed": packed, "dq": packed,
                                    "dkv": packed},
                             conv={"fwd": 6, "dx": 6}),
             launches_wanted(fused={"main": 7}, flash={"packed": packed},
                             conv={"fwd": 6})),
            ("MobileNetLarge3D", "mobilenet_large_50k.json",
             *[launches_wanted(fused={"pool": 8, "main": 15})] * 2),
            ("MobileNetSmall3D", "mobilenet_small_50k.json",
             *[launches_wanted(fused={"pool": 9, "main": 11})] * 2),
            ("MoViNetA2", "movinet_a2_50k.json", *[launches_wanted()] * 2)]
        for label, cfg_file, per_micro, per_eval in cli_runs:
            t0 = time.perf_counter()
            train[label] = phase_train_cli(label, cfg_file, counters,
                                           per_micro=per_micro,
                                           per_eval=per_eval)
            seconds[f"train_{label}"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        train["backends"] = phase_train_backends(counters, feats, labels)
        train["grads"] = {
            "MobileViT-s": grads_against_plain("MobileViT-s", mobilevit_s, x,
                                               labels),
            "MobileNetLarge3D": grads_against_plain("MobileNetLarge3D",
                                                    large3d, x, labels)}
        seconds["train_backends_and_grads"] = time.perf_counter() - t0
    if selected("timing"):
        train["timing"] = {
            label: phase_train_timing(
                label, make, feats, x, labels, gpu_line,
                vit_turns=label == "MobileViT-s")
            for label, make in (("MobileViT-s", mobilevit_s),
                                ("MobileNetLarge3D", large3d),
                                ("MobileNetSmall3D", small3d),
                                ("MoViNetA2", movinet_a2))}
        seconds["train_timing"] = sum(t["seconds"]
                                      for t in train["timing"].values())
    seconds["total"] = time.perf_counter() - T_START
    emit({"phase": "seconds", **seconds})

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    record = {"card": gpu_line, "seconds": seconds, "sass": sass,
              "geometries": rows, "large_batch": large_batch, "flash": flash,
              "flash_bwd": flash_bwd, "packed_min_seq_sweep": sweep,
              "folded_conv": conv,
              "serve": {"MobileNetLarge3D": large, "MobileViT-s": vit,
                        "MobileNetSmall3D": small, "MoViNetA2": movinet},
              "train": train}
    if only:
        skipped = [p for p in PHASES if not selected(p)
                   and not (p in ("fused", "conv", "flash")
                            and selected("kernels"))]
        emit({"phase": "skipped", "phases": skipped,
              "note": "a partial run (--only): no summary line"})
        with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_only.json"),
                  "w") as f:
            json.dump(dict(record, only=sorted(only)), f, indent=1)
        print(gpu_line, flush=True)
        emit({"ok": True, "only": sorted(only),
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return 0

    # launches of each main-path run, read just after it
    runs = {"serve_large3d": large["launches"],
            "serve_small3d": small["launches"],
            "serve_mobilevit": vit["launches"]["fused"],
            **{f"forward_mobilevit_{b}": vit[b]["launches"]["fused"]
               for b in ("pallas", "pallas_packed")},
            **{f"train_{m}": train[m]["launches"]["fused"]
               for m in ("MobileViT-s", "MobileNetLarge3D",
                         "MobileNetSmall3D")},
            **{f"train_step_mobilevit_{b}":
               train["backends"][b]["launches"]["fused"]
               for b in ("pallas", "pallas_packed")}}
    flash_runs = {"serve_mobilevit": vit["launches"]["flash"],
                  **{f"forward_mobilevit_{b}": vit[b]["launches"]["flash"]
                     for b in ("pallas", "pallas_packed")},
                  "train_MobileViT-s":
                  train["MobileViT-s"]["launches"]["flash"]}
    heads_bwd_runs = {f"train_step_mobilevit_{b}":
                      train["backends"][b]["launches"]["flash"]
                      for b in ("pallas", "pallas_packed")}
    flash_runs.update(heads_bwd_runs)
    conv_runs = {"serve_mobilevit": vit["launches"]["conv"],
                 **{f"forward_mobilevit_{b}": vit[b]["launches"]["conv"]
                    for b in ("pallas", "pallas_packed")},
                 "train_MobileViT-s":
                 train["MobileViT-s"]["launches"]["conv"],
                 **{f"train_step_mobilevit_{b}":
                    train["backends"][b]["launches"]["conv"]
                    for b in ("pallas", "pallas_packed")}}
    tpu = "picklebot_tpu/ops/pallas/"
    kernels = [
        fused_entry("pool", 86, fused_per, runs),
        fused_entry("main", 103, fused_per, runs),
        flash_entry("flash_packed_fwd", "packed",
                    f"{tpu}flash_packed.py:122", flash, flash_runs,
                    VIT_PACKED),
        flash_entry("flash_fwd", "heads", f"{tpu}flash_attention.py:47",
                    flash, flash_runs, dict(VIT_ATTENTION)),
        flash_bwd_entry("flash_packed_bwd_dq", "dq",
                        f"{tpu}flash_packed.py:271", flash_bwd, "packed",
                        {"train_MobileViT-s":
                         train["MobileViT-s"]["launches"]["flash"]},
                        VIT_PACKED),
        flash_bwd_entry("flash_packed_bwd_dkv", "dkv",
                        f"{tpu}flash_packed.py:304", flash_bwd, "packed",
                        {"train_MobileViT-s":
                         train["MobileViT-s"]["launches"]["flash"]},
                        VIT_PACKED),
        flash_bwd_entry("flash_bwd_dq", "dq", f"{tpu}flash_attention.py:146",
                        flash_bwd, "heads", heads_bwd_runs,
                        dict(VIT_ATTENTION)),
        flash_bwd_entry("flash_bwd_dkv", "dkv",
                        f"{tpu}flash_attention.py:173", flash_bwd, "heads",
                        heads_bwd_runs, dict(VIT_ATTENTION)),
        conv_entry("fwd", conv, conv_runs),
        conv_entry("dx", conv, {k: r for k, r in conv_runs.items()
                                if k.startswith("train_")}),
    ]
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(dict(record, kernels=kernels), f, indent=1)
    print(gpu_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
