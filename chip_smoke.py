#!/usr/bin/env python3
"""Run the PyTorch/CUDA port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases, in order (each prints JSON lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi), torch and CUDA
  2. build    nvcc builds every kernel from picklebot_tpu_torch/csrc/
  3. kernels  each kernel against its plain PyTorch version at the 15
              MobileNetLarge3D bottleneck geometries of a bs-8, 32x224x224
              clip batch (bf16), plus one f32 case with TF32 off; kernel,
              plain and cuDNN-chain times by CUDA events, and each
              geometry's bound
  4. serve    picklebot_tpu_torch.serve.main on 16 synthetic clips at full
              width from a seeded .pth; checks the predictions, that every
              kernel launched as often as the model has blocks, and one
              batch's logits against the plain path on the card; then the
              predict throughput at bs 8
  5. summary  {"kernels": [...]} and, last, {"ok": true, "device": ...}
Per-geometry numbers also go to chiprun_out/chip_smoke.json. Without CUDA
it exits with code 2 and prints no result. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

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
# bf16: the plain path rounds the expanded and depthwise tensors to bf16
# (2^-9 relative each) where the kernel keeps them f32, so outputs differ
# by a few bf16 ulps of the output's range; 3% of max|plain| bounds that.
BF16_REL_TOL = 3e-2
# f32 with TF32 off: the same f32 chain summed in another order.
F32_REL_TOL = 1e-4
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


def bound(shape, k, s, e, co, elem, pass_):
    """Least time (ms) for one pass on an H100 at this geometry:
    max(bytes / 3.35 TB/s, FLOPs / peak), as a dict of bound_ms,
    bytes_ms, ops_ms and bound_by. Bytes: the input frames the output
    reads, the weights and the output, once each (no expanded tensor).
    FLOPs: expand over those frames, depthwise, and for the main pass the
    scale and projection (the pool pass's recompute is its own row)."""
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
    peak = PEAK_FLOPS["bfloat16" if elem == 2 else "float32"]
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bytes_ms=t_bytes, ops_ms=t_ops,
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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


def check_close(name, got, want, rel_tol):
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    ok = err <= rel_tol * ref + 1e-6
    if not ok:
        raise AssertionError(f"{name}: max abs err {err} > {rel_tol} * "
                             f"max|ref| {ref}")
    return err, ref


def phase_kernels():
    import torch
    from picklebot_tpu_torch.ops import fused_bottleneck as fb

    rows, per = [], {"pool": [], "main": []}
    for i, (shape, k, s, se, e, co) in enumerate(GEOMETRIES):
        x, w = make_case(shape, k, e, co, torch.bfloat16, seed=i)
        b, t, h, wd_, c = shape
        to, ho, wo = fb.out_shape(t, h, wd_, k, s)
        row = {"block": i, "x": list(shape), "k": k, "s": s, "se": se,
               "E": e, "out": [b, to, ho, wo, co]}
        if se:
            want = fb.pool_reference(x, w["w1"], w["wd"], k, s)
            got = fb.fused_pool(x, w["w1"], w["wd"], k, s)
            torch.cuda.synchronize()
            err, ref = check_close(f"pool block {i}", got, want,
                                   BF16_REL_TOL)
            per["pool"].append(dict(
                err=err, **bound(shape, k, s, e, co, 2, "pool"),
                ms=time_ms(lambda: fb.fused_pool(x, w["w1"], w["wd"], k,
                                                 s)),
                plain_ms=time_ms(lambda: fb.pool_reference(
                    x, w["w1"], w["wd"], k, s)),
                library_ms=time_ms(lambda: library_chain(
                    x, w, k, s, None, False))))
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
            raise AssertionError(f"main block {i}: shape {got.shape}")
        err, ref = check_close(f"main block {i}", got, want, BF16_REL_TOL)
        per["main"].append(dict(
            err=err, **bound(shape, k, s, e, co, 2, "main"),
            ms=time_ms(lambda: fb.fused_main(x, w["w1"], w["wd"], w["w2"],
                                             scale, k, s)),
            plain_ms=time_ms(lambda: fb.main_reference(
                x, w["w1"], w["wd"], w["w2"], scale, k, s)),
            library_ms=time_ms(lambda: library_chain(x, w, k, s, scale,
                                                     True))))
        row["main"] = dict(per["main"][-1], max_ref=ref)
        emit({"phase": "kernels", **row})
        rows.append(row)
        del x, w, got, want

    # one f32 case, TF32 off, tight tolerance: block3[0] (k5, s2, SE)
    from picklebot_tpu_torch.core.policy import DtypePolicy
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
    return rows, per


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


def phase_serve(gpu_line):
    import torch
    from picklebot_tpu_torch import serve
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.data.dataset import ClipDataset, pad_collate
    from picklebot_tpu_torch.models.mobilenet3d import MobileNetLarge3D
    from picklebot_tpu_torch.ops import fused_bottleneck as fb
    from picklebot_tpu_torch.train.step import make_predict_fn, preprocess

    cfg = {"model_name": "MobileNetLarge3D", "num_classes": 13,
           "use_autocast": True, "data_backend": "synthetic",
           "synthetic_shape": [32, 224, 224], "t_bucket": 16,
           "max_frames": 128, "synthetic_len": 16}
    ds = ClipDataset("", "", backend="synthetic",
                     synthetic_shape=(32, 224, 224), synthetic_len=16)
    feats, _ = pad_collate([ds[i][0] for i in range(8)], [0] * 8, 16, 128)
    x = preprocess(torch.from_numpy(feats).cuda(), torch.bfloat16)

    model = MobileNetLarge3D(13, seed=0).cuda().eval()
    calibrate_batchnorm(model, x)
    n_se = sum(b.use_se for b in model.bottlenecks())
    n_blocks = len(list(model.bottlenecks()))
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        pth = os.path.join(tmp, "weights.pth")
        torch.save({k: v.cpu() for k, v in model.state_dict().items()}, pth)

        fb.LAUNCHES.update(pool=0, main=0)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = serve.main([cfg_path, "--checkpoint", pth, "--csv",
                             "synthetic", "--limit", "16", "--batch", "8"])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = dict(fb.LAUNCHES)
    lines = [json.loads(l) for l in out.getvalue().splitlines()
             if l.startswith("{")]
    preds = [l for l in lines if "pred" in l]
    if rc != 0 or len(preds) != 16 or "evaluated" not in lines[-1]:
        raise AssertionError(f"serve: rc {rc}, {len(preds)} predictions, "
                             f"last line {lines[-1] if lines else None}")
    if not all(0 <= p["pred"] < 13 and 0 < p["confidence"] <= 1
               for p in preds):
        raise AssertionError(f"serve: bad prediction lines {preds}")
    want = {"pool": 2 * n_se, "main": 2 * n_blocks}
    if launches != want:
        raise AssertionError(f"serve: launches {launches}, want {want}")
    emit({"phase": "serve", "predictions": len(preds),
          "evaluated": lines[-1], "launches": launches,
          "serve_wall_s": serve_s})

    # one batch: kernel path against the plain path, both on the card
    with torch.inference_mode():
        got = model(x).float()
        ref = model(x, kernels=False).float()
    if not torch.isfinite(got).all():
        raise AssertionError("serve: non-finite logits")
    err = (got - ref).abs().max().item()
    scale_ = ref.abs().max().item()
    tol = LOGIT_REL_TOL * scale_
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 2 * tol
    argmax_ok = bool((got.argmax(-1) == ref.argmax(-1))[clear].all())
    if err > tol or not argmax_ok:
        raise AssertionError(f"serve logits: max abs err {err} (tol {tol}),"
                             f" argmax agrees where clear: {argmax_ok}")
    emit({"phase": "serve", "logits_max_abs_err": err,
          "logits_max_abs": scale_, "rel_tol": LOGIT_REL_TOL,
          "argmax_agree": int((got.argmax(-1) == ref.argmax(-1)).sum()),
          "argmax_clear": int(clear.sum())})

    # throughput: predict() from a host uint8 batch to host logits
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
    result = {"phase": "serve", "batch": 8, "clip": [32, 224, 224],
              "predict_clips_per_s": 8 * reps / dt,
              "forward_ms": fwd_ms, "forward_plain_ms": plain_ms,
              "card": gpu_line, "launches": launches}
    emit(result)
    return result


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
    libs = build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(libs)})
    for path in libs.values():
        log = path.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip(), file=sys.stderr)

    rows, per = phase_kernels()
    serve_result = phase_serve(gpu_line)

    launches = serve_result["launches"]   # counted in the serve run only
    source = "picklebot_tpu_torch/csrc/fused_bottleneck.cu"
    tpu = "picklebot_tpu/ops/pallas/fused_bottleneck.py"
    kernels = []
    for name, line in (("pool", 86), ("main", 103)):
        r = per[name]
        ms = sum(v["ms"] for v in r)
        kernels.append({
            "name": f"fused_bottleneck_{name}", "route": "cuda",
            "source": source, "replaces": f"{tpu}:{line}",
            "launches": launches[name],
            "max_abs_err": max(v["err"] for v in r),
            "ms": ms, "kernel_ms": ms,
            "plain_ms": sum(v["plain_ms"] for v in r),
            "bound_ms": sum(v["bound_ms"] for v in r),
            "bound_by": ("bytes" if sum(v["bytes_ms"] for v in r)
                         >= sum(v["ops_ms"] for v in r) else "operations"),
            "library_ms": sum(v["library_ms"] for v in r),
            "per_forward": f"sum over the {len(r)} geometries of one "
                           "bs-8 forward"})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump({"card": gpu_line, "geometries": rows,
                   "serve": serve_result, "kernels": kernels}, f, indent=1)
    print(gpu_line, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
