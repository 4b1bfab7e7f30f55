"""Throughput of the port on one card: ``python -m picklebot_tpu_torch.bench``.

Counterpart of the root ``bench.py`` and of its harness
(``picklebot_tpu/utils/autotune.py`` ``measure_plan``). It prints ONE JSON
line: ``metric``, ``value`` (clips/s, or images/s for MobileViTV2),
``unit``, ``timing``, ``vs_baseline`` (always null: the port states no
ratio to the reference's GPU number nor to a TPU) and ``device``, the
card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them.

    python -m picklebot_tpu_torch.bench [--mode train|infer] [--model M]
        [--variant xxs|xs|s] [--batch 16] [--frames 32] [--size 224]
        [--steps 50] [--warmup 3] [--device cuda]
    python -m picklebot_tpu_torch.bench --matrix [--only Large3D]
        [--matrix-out FILE] [--matrix-append]

The workload is ``bench.py``'s: the model at 13 classes (MobileViT with
the variant's dims and channels), bf16 compute, a uint8 batch made by
``np.random.RandomState(0)`` in (B, T, H, W, 3), or (B, H, W, 3) for the
image model MobileViTV2, moved to the device with its labels before any
timing. ``train`` is the port's ``make_train_step`` on one microbatch
(preprocess, forward, CE loss, backward, the config's AdamW8bit at the
cosine schedule's rate); ``infer`` is preprocess and the eval-mode
forward under ``torch.inference_mode``, the logits left on the device.
Both run the port's own path: on the card the MobileNet3D and MobileViT
models launch the hand-written kernels.

Timing ``events``: CUDA events around n back-to-back steps with no host
sync between them, one ``torch.cuda.synchronize()`` closing each window;
after ``--warmup`` steps, n starts at ``--steps`` and doubles until a
window lasts 0.3 s, and the best of 2 windows counts. The number is the
eager program the port's users run: no CUDA graph, no ``torch.compile``.
With ``--device cpu`` (for tests; never the default) the windows are
timed by the host clock and ``timing`` says ``host``: no device number.

``--matrix`` measures the port's copy of ``bench.py``'s ``MATRIX_ROWS``
and writes one JSON artifact, row by row and atomically, as the JAX
matrix does; a row that fails (an out-of-memory error, or an option the
port does not have) is recorded with its error and the matrix goes on.
Each measured row adds ``ms_per_step``, ``tflops`` and ``mfu_pct``: the
FLOPs of one step counted by ``torch.utils.flop_counter.FlopCounterMode``
(matmuls and convs; a grouped conv's backward by ``count_flops``'s own
formula) over the plain path of the same step (``kernels=False``; the
kernels' launches are invisible to that counter and compute the same
function),
over the dense bf16 peak of an H100 SXM, 989 TFLOP/s (on the card only:
a CPU row has no device rate). The JAX matrix's
``hbm_*`` columns are left out: the port has no counterpart of XLA's
count of bytes accessed.

``--remat N`` checkpoints N levels of module calls in a train step
(``core/remat.py``). ``--baked`` (inference only) times the serving
program of ``export.py`` instead of the eager model: the predictor
exported with the weights inside, saved and loaded back, the kernels in
it as custom ops, as the JAX bench's ``graph-baked`` times its AOT
serving program. Not offered: the JAX bench's ``--s2d``, ``--early-fold``
and ``--fold-span`` pick TPU layout rewrites that the port does not
carry.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from picklebot_tpu_torch.core.policy import DtypePolicy
from picklebot_tpu_torch.models.mobilevit import MOBILEVIT_CONFIGS
from picklebot_tpu_torch.models.registry import PORTED, initialize_model
from picklebot_tpu_torch.ops.linear import dropout_rng
from picklebot_tpu_torch.train.losses import LOSSES, prepare_labels
from picklebot_tpu_torch.train.optim import OPTIMIZERS, cosine_annealing_lr
from picklebot_tpu_torch.train.step import make_train_step, preprocess
from picklebot_tpu_torch.utils.config import Config
from picklebot_tpu_torch.utils.devices import resolve_device

MIN_WINDOW_S = 0.3
REPEATS = 2
PEAK_BF16_FLOPS = 989e12            # H100 SXM, dense
IMAGE_MODELS = ("MobileViTV2",)

# bench.py's MATRIX_ROWS: (model, variant, mode, batch, frames, size,
# baked[, remat])
MATRIX_ROWS = [
    ("MobileNetLarge3D", None, "train", 16, 32, 224, False),
    ("MobileNetLarge3D", None, "train", 64, 32, 224, False),
    ("MobileNetLarge3D", None, "train", 128, 32, 224, False),
    ("MobileNetLarge3D", None, "train", 256, 32, 224, False),
    ("MobileNetLarge3D", None, "train", 256, 32, 224, False, 1),
    ("MobileNetLarge3D", None, "infer", 16, 32, 224, False),
    ("MobileNetLarge3D", None, "infer", 64, 32, 224, False),
    ("MobileNetLarge3D", None, "infer", 128, 32, 224, False),
    ("MobileNetLarge3D", None, "infer", 256, 32, 224, False),
    ("MobileNetLarge3D", None, "infer", 16, 32, 224, True),
    ("MobileNetLarge3D", None, "infer", 128, 32, 224, True),
    ("MobileNetLarge3D", None, "infer", 256, 32, 224, True),
    ("MobileNetSmall3D", None, "train", 16, 32, 224, False),
    ("MobileNetSmall3D", None, "train", 64, 32, 224, False),
    ("MobileNetSmall3D", None, "infer", 16, 32, 224, False),
    ("MobileNetSmall3D", None, "infer", 64, 32, 224, False),
    ("MobileNetSmall3D", None, "infer", 64, 32, 224, True),
    ("MoViNetA2", None, "train", 8, 32, 224, False),
    ("MoViNetA2", None, "train", 32, 32, 224, False),
    ("MoViNetA2", None, "infer", 32, 32, 224, False),
    ("MoViNetA2", None, "infer", 64, 32, 224, False),
    ("MoViNetA2", None, "infer", 64, 32, 224, True),
    ("MobileViT", "xxs", "train", 8, 16, 256, False),
    ("MobileViT", "xxs", "infer", 8, 16, 256, False),
    ("MobileViT", "xxs", "infer", 32, 16, 256, False),
    ("MobileViT", "xxs", "infer", 32, 16, 256, True),
    ("MobileViT", "xs", "train", 8, 16, 256, False),
    ("MobileViT", "xs", "infer", 8, 16, 256, False),
    ("MobileViT", "s", "train", 8, 16, 256, False),
    ("MobileViT", "s", "infer", 8, 16, 256, False),
    ("MobileNetLarge2D", None, "train", 8, 16, 224, False),
    ("MobileNetLarge2D", None, "infer", 8, 16, 224, False),
    ("MobileNetLarge2D", None, "infer", 64, 16, 224, False),
    ("MobileNetLarge2D", None, "infer", 64, 16, 224, True),
    ("MobileNetSmall2D", None, "train", 8, 16, 224, False),
    ("MobileNetSmall2D", None, "infer", 8, 16, 224, False),
    ("MobileNetSmall2D", None, "infer", 64, 16, 224, False),
    ("MobileViTV2", None, "train", 32, 0, 256, False),
    ("MobileViTV2", None, "infer", 32, 0, 256, False),
    ("MobileViTV2", None, "infer", 128, 0, 256, False),
    ("MobileViTV2", None, "infer", 128, 0, 256, True),
    ("MobileViTV2", None, "infer", 256, 0, 256, False),
]


def check_ported(baked: bool, mode: str = "infer"):
    """Raise ValueError for an option that the mode does not take."""
    if baked and mode != "infer":
        raise ValueError(
            "--baked times the exported serving program (export.py, "
            "ROADMAP.md A17), which is inference-only (training weights "
            "change every step); add --mode infer")


def bench_config(model: str, variant: str = "xxs") -> Config:
    """bench.py's config: 13 classes, MobileViT at the variant's widths,
    every other option the default (bf16, CE, AdamW8bit)."""
    return Config(model_name=model, num_classes=13,
                  **MOBILEVIT_CONFIGS[variant or "xxs"]).validate()


def input_shape(model: str, batch: int, frames: int, size: int):
    if model in IMAGE_MODELS:
        return (batch, size, size, 3)
    return (batch, frames, size, size, 3)


def baked_program(model, policy, model_name, shape, device):
    """The serving program of ``export.py`` for ``model``: exported with
    a symbolic batch at ``shape``'s frames and size, saved and loaded
    back, as ``serve --exported`` runs it."""
    from picklebot_tpu_torch.export import export_predictor, save_artifact
    image = model_name in IMAGE_MODELS
    program = export_predictor(model, policy, frames=None if image
                               else shape[1], size=shape[-2],
                               model_name=model_name, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "program.pt2")
        save_artifact(path, program, {})
        return torch.export.load(path).module()


def device_line(device: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or ``cpu``."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", f"--id={device.index or 0}",
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Workload:
    """One bench step of ``cfg`` at ``shape`` on ``device``, its data
    already there: ``run()`` enqueues one step."""

    def __init__(self, cfg: Config, mode: str, shape, device,
                 remat: int = 0, baked: bool = False):
        self.cfg, self.mode, self.device = cfg, mode, device
        self.program = None
        self.policy = DtypePolicy.bf16() if cfg.use_autocast else \
            DtypePolicy.f32()
        self.model = initialize_model(cfg).to(device)
        rng = np.random.RandomState(0)
        feats = rng.randint(0, 255, shape).astype(np.uint8)
        self.batch = batch = shape[0]
        hi = 2 if cfg.criterion == "BCE" else cfg.num_classes
        labels = rng.randint(0, hi, (1, batch)).astype(np.int64)
        if mode == "train":
            self.feats = torch.from_numpy(feats[None]).to(device)
            self.labels = torch.from_numpy(labels).to(device)
            opt = OPTIMIZERS[cfg.optimizer](self.model.parameters(),
                                            weight_decay=cfg.weight_decay)
            self.step = make_train_step(
                self.model, opt, cfg.criterion,
                cosine_annealing_lr(cfg.learning_rate,
                                    max(cfg.max_iters, 1)),
                self.policy, seed=cfg.seed, device=device, remat=remat,
                data_parallel=False)
        elif mode == "infer":
            self.feats = torch.from_numpy(feats).to(device)
            self.model.eval()
            if baked:
                self.program = baked_program(self.model, self.policy,
                                             cfg.model_name, shape, device)
        else:
            raise ValueError(f"mode {mode!r} (train or infer)")

    def run(self):
        if self.mode == "train":
            return self.step(0, self.feats, self.labels)["loss"]
        if self.program is not None:
            with torch.no_grad(), self.policy.precision():
                return self.program(self.feats)
        with torch.inference_mode(), self.policy.precision():
            return self.model(preprocess(self.feats,
                                         self.policy.compute_dtype))

    def flops(self) -> int:
        """FLOPs of one step's forward (and backward in train), counted
        on the plain path (``kernels=False``) of the same step."""
        dtype = self.policy.compute_dtype
        counter = count_flops()
        if self.mode == "infer":
            with counter, torch.inference_mode(), self.policy.precision():
                self.model(preprocess(self.feats, dtype), kernels=False)
            return counter.get_total_flops()
        loss_fn = LOSSES[self.cfg.criterion][0]
        self.model.train()
        gen = torch.Generator(device=self.device).manual_seed(0)
        with counter, self.policy.precision(), dropout_rng(gen):
            x = preprocess(self.feats[0], dtype)
            logits = self.model(x, kernels=False)
            loss_fn(logits, prepare_labels(self.cfg.criterion,
                                           self.labels[0])).backward()
        self.model.zero_grad(set_to_none=True)
        return counter.get_total_flops()


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, _bias, _stride,
                         _padding, _dilation, transposed, _output_padding,
                         _groups, output_mask, out_shape=None, **kwargs):
    """FLOPs of ``aten.convolution_backward`` with the groups counted: the
    input gradient and the weight gradient each cost what the forward
    conv costs, 2 per weight element, sample and output position (input
    position for a transposed conv). The counter's own formula leaves the
    groups out and counts a depthwise conv's backward as a dense one's,
    ``groups`` times too many."""
    positions = math.prod((x_shape if transposed else grad_out_shape)[2:])
    forward = 2 * math.prod(w_shape) * x_shape[0] * positions
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def count_flops():
    """A FlopCounterMode that counts grouped convs' backward right."""
    from torch.utils.flop_counter import FlopCounterMode
    return FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})


def _window_s(run, n: int, device) -> float:
    """Seconds of ``n`` back-to-back ``run()`` calls: CUDA events closed
    by one synchronize on the card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(n):
        run()
    return time.perf_counter() - t0


def measure(work: Workload, steps: int, warmup: int,
            min_window: float = MIN_WINDOW_S, repeats: int = REPEATS):
    """Samples/s of ``work``: after ``warmup`` steps, ``steps`` doubled
    until a window lasts ``min_window`` s, the best of ``repeats``
    windows. Returns (samples/s, steps per window)."""
    for _ in range(warmup):
        work.run()
    if work.device.type == "cuda":
        torch.cuda.synchronize(work.device)
    n = max(steps, 1)
    dt = _window_s(work.run, n, work.device)
    while dt < min_window:
        n *= 2
        dt = _window_s(work.run, n, work.device)
    for _ in range(repeats - 1):
        dt = min(dt, _window_s(work.run, n, work.device))
    return work.batch * n / dt, n


def metric_name(model, variant, mode, batch, frames, size,
                device, baked=False) -> str:
    image = model in IMAGE_MODELS
    per = "card" if device.type == "cuda" else "cpu"
    what = ("train step fwd+bwd+adamw8bit" if mode == "train"
            else "batched inference, weights baked (exported program)"
            if baked else "batched inference")
    clip = f"{size}x{size}" if image else f"T={frames} {size}x{size}"
    name = f"{model}-{variant}" if model == "MobileViT" else model
    return (f"{'images' if image else 'clips'}/sec/{per} ({name} {what}, "
            f"bs={batch} {clip} bf16)")


def measure_row(model, variant, mode, batch, frames, size, baked, remat=0,
                steps=50, warmup=3, device="cuda"):
    """One matrix row -> its record: the measurement with the step's
    FLOPs, or the error that stopped it."""
    device = torch.device(device)
    image = model in IMAGE_MODELS
    row = {"model": model, "variant": variant, "mode": mode,
           "batch": batch, "frames": None if image else frames,
           "size": size, "baked": baked,
           "timing": "events" if device.type == "cuda" else "host",
           "steps": steps, "unit": "images/s" if image else "clips/s"}
    if remat:
        row["remat"] = remat
    try:
        check_ported(baked, mode)
        work = Workload(bench_config(model, variant), mode,
                        input_shape(model, batch, frames, size), device,
                        remat, baked)
        row["value"], row["steps_per_window"] = measure(work, steps, warmup)
        step_s = batch / row["value"]
        row["ms_per_step"] = 1e3 * step_s
        row["flops_per_step"] = work.flops()
        if device.type == "cuda":       # no device rate from a CPU run
            row["tflops"] = row["flops_per_step"] / step_s / 1e12
            row["mfu_pct"] = 100 * row["tflops"] * 1e12 / PEAK_BF16_FLOPS
    except Exception as e:  # noqa: BLE001 -- recorded; the matrix goes on
        row["value"] = None
        row["error"] = f"{type(e).__name__}: {e}"[:500]
    finally:
        work = None
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return row


def _row_key(r: dict):
    return (r["model"], r.get("variant"), r["mode"], r["batch"],
            r.get("frames") or 0, r["size"], bool(r.get("baked")),
            int(r.get("remat", 0)))


def run_matrix(args) -> dict:
    """Measure MATRIX_ROWS (those whose model name holds ``--only``) into
    ``--matrix-out``, rewritten atomically after every row; with
    ``--matrix-append`` the rows already recorded there, measured or
    failed, are kept and skipped."""
    device = resolve_device(args.device)
    rows = [r for r in MATRIX_ROWS
            if not args.only or args.only.lower() in r[0].lower()]
    out = {"rows": [], "steps": args.steps, "device": device_line(device),
           "started": time.strftime("%Y-%m-%d %H:%M:%S")}
    done = set()
    if args.matrix_append and os.path.exists(args.matrix_out):
        with open(args.matrix_out) as fh:
            out = json.load(fh)
        done = {_row_key(r) for r in out["rows"]}
        out["appended"] = time.strftime("%Y-%m-%d %H:%M:%S")
    for r in rows:
        model, variant, mode, batch, frames, size, baked = r[:7]
        remat = int(r[7]) if len(r) > 7 else 0
        if _row_key({"model": model, "variant": variant, "mode": mode,
                     "batch": batch, "frames": frames, "size": size,
                     "baked": baked, "remat": remat}) in done:
            continue
        t0 = time.perf_counter()
        row = measure_row(*r, steps=args.steps, warmup=args.warmup,
                          device=device)
        row["measure_wall_s"] = time.perf_counter() - t0
        out["rows"].append(row)
        print(json.dumps(row), flush=True)
        tmp = args.matrix_out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(out, fh, indent=1)
        os.replace(tmp, args.matrix_out)
    print(f"# matrix: {len(out['rows'])} rows -> {args.matrix_out}",
          flush=True)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Throughput of the PyTorch/CUDA port: one JSON line")
    p.add_argument("--mode", default="train", choices=["train", "infer"])
    p.add_argument("--model", default="MobileNetLarge3D", choices=PORTED,
                   help="any registry model (MobileViT at --variant)")
    p.add_argument("--variant", default="xxs", choices=sorted(
        MOBILEVIT_CONFIGS), help="MobileViT's size (the reference's "
        "config/mobilevit_*.json dims and channels)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--steps", type=int, default=50,
                   help="steps of the first timed window (doubled until "
                   "a window lasts 0.3 s)")
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    p.add_argument("--baked", action="store_true",
                   help="infer: time the exported serving program "
                   "(export.py) loaded back, not the eager model")
    p.add_argument("--remat", type=int, default=0,
                   help="train: checkpoint this many levels of module "
                   "calls (activation rematerialization)")
    p.add_argument("--matrix", action="store_true",
                   help="measure MATRIX_ROWS into one JSON artifact")
    p.add_argument("--matrix-out", default="BENCH_MATRIX_TORCH.json")
    p.add_argument("--matrix-append", action="store_true",
                   help="keep the rows --matrix-out already records and "
                   "measure only the others")
    p.add_argument("--only", default=None,
                   help="matrix row filter (substring of the model name)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Print the bench's JSON line (or run the matrix) and return it."""
    args = parse_args(argv)
    if args.matrix:
        return run_matrix(args)
    check_ported(args.baked, args.mode)
    device = resolve_device(args.device)
    shape = input_shape(args.model, args.batch, args.frames, args.size)
    work = Workload(bench_config(args.model, args.variant), args.mode,
                    shape, device, args.remat, args.baked)
    value, n = measure(work, args.steps, args.warmup)
    line = {"metric": metric_name(args.model, args.variant, args.mode,
                                  args.batch, args.frames, args.size,
                                  device, args.baked),
            "value": value,
            "unit": "images/s" if args.model in IMAGE_MODELS else "clips/s",
            "vs_baseline": None,
            "timing": "events" if device.type == "cuda" else "host",
            "steps_per_window": n, "device": device_line(device)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
