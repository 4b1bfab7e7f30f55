"""Ahead-of-time serving artifacts: the predictor as one exported program.

Counterpart of ``picklebot_tpu/export.py``. ``export_predictor`` traces the
predictor (uint8 clips -> preprocess -> eval forward -> f32 logits) once
with ``torch.export`` under ``torch.no_grad()``, the trained weights
inside, and ``save_artifact`` writes it as one file (``torch.export.save``)
with a ``metadata.json`` beside the program: ``model_name``,
``num_classes``, ``criterion``, ``frames``, ``size``, ``batch``,
``sample_fps``, ``compute_dtype``, ``device``, ``torch_version``,
``input`` and ``output``.

The batch dimension is symbolic by default (``Dim("b")``), so one artifact
serves any batch size; ``--batch N`` pins it. Frames and size are fixed:
``serve --exported`` pads or trims T and resizes frames on the host.

The hand-written kernels stay in the program as the custom ops of
``ops/library.py`` (``picklebot::fused_pool``, ``picklebot::fused_main``,
``picklebot::flash_packed``, ``picklebot::flash_heads``,
``picklebot::flash_qkvpacked``, ``picklebot::folded_conv_fwd``): on the
card the loaded program launches them, on the CPU it runs their plain
versions. Loading (``load_artifact``) needs torch and those registrations
(``import picklebot_tpu_torch.ops``) only: no model zoo, no config, no
checkpoint. An artifact is bound to the device it was exported on, whose
tensors and kernels it holds; ``load_artifact`` refuses it on another.
The JAX package's ``.pbz`` (StableHLO) is not readable here, nor is this
artifact readable by the JAX package.

Usage:
  python -m picklebot_tpu_torch.export <config.json> --checkpoint w.pth \
      --out model.pt2 [--frames 32] [--size 224] [--batch -1] [--ema] \
      [--device cuda]
  python -m picklebot_tpu_torch.serve --exported model.pt2 clip1.mp4 ...
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile

import torch

METADATA_NAME = "metadata.json"
IMAGE_MODELS = ("MobileViTV2",)


class Predictor(torch.nn.Module):
    """uint8 clips (B, T, H, W, 3), or images (B, H, W, 3) for
    MobileViTV2, -> f32 (B, num_classes) logits: ``preprocess`` and the
    eval-mode forward, MoViNetA2Stream's whole-clip pass from a zero
    carry built inside (one chunk holding the whole clip)."""

    def __init__(self, model, policy, mean=None, std=None, model_name=""):
        super().__init__()
        self.model = model.eval()
        self.compute_dtype = policy.compute_dtype
        self.mean, self.std = mean, std
        self.stream = model_name == "MoViNetA2Stream"

    def forward(self, features):
        from picklebot_tpu_torch.train.step import preprocess

        x = preprocess(features, self.compute_dtype, self.mean, self.std)
        if self.stream:
            carry = self.model.init_stream(x.shape[0], x.shape[2],
                                           x.shape[3], x.dtype, x.device)
            logits = self.model(x, carry)[0]
        else:
            logits = self.model(x)
        return logits.float()


def build_predict_fn(model, policy, mean=None, std=None, model_name=""):
    """The predictor module that ``export_predictor`` traces (weights are
    ``model``'s)."""
    return Predictor(model, policy, mean, std, model_name)


def export_predictor(model, policy, *, frames, size, mean=None, std=None,
                     model_name="", batch=None, device="cuda"):
    """Trace the predictor on ``device`` (the model must live there) and
    return a ``torch.export.ExportedProgram``. ``batch=None`` exports a
    symbolic batch dim ``b``; an int pins it. MobileViTV2 takes images
    (B, size, size, 3), every other model clips (B, frames, size, size,
    3)."""
    device = torch.device(device)
    predictor = build_predict_fn(model, policy, mean, std, model_name)
    shape = ((2, size, size, 3) if model_name in IMAGE_MODELS
             else (2, frames, size, size, 3))
    if batch is not None:
        shape = (int(batch),) + shape[1:]
    example = torch.zeros(shape, dtype=torch.uint8, device=device)
    dynamic = None if batch is not None else (
        {0: torch.export.Dim("b", min=1)},)
    with torch.no_grad(), policy.precision():
        return torch.export.export(predictor, (example,),
                                   dynamic_shapes=dynamic, strict=False)


def save_artifact(path, program, meta: dict):
    """Write the program and its ``metadata.json`` as one file."""
    torch.export.save(program, str(path),
                      extra_files={METADATA_NAME: json.dumps(meta, indent=1)})


def read_metadata(path) -> dict:
    """The artifact's metadata, read without loading the program."""
    with zipfile.ZipFile(str(path)) as z:
        name = next(n for n in z.namelist()
                    if n.endswith(f"/{METADATA_NAME}") or n == METADATA_NAME)
        return json.loads(z.read(name))


def _device_key(device) -> str:
    device = torch.device(device)
    return "cpu" if device.type == "cpu" else f"cuda:{device.index or 0}"


def load_artifact(path, device="cuda"):
    """(callable uint8 numpy or tensor batch -> f32 numpy logits, metadata).

    Raises ValueError when the artifact was exported for another device:
    it is never moved. An f32 artifact runs with TF32 off, as the eager
    f32 path does."""
    import numpy as np

    import picklebot_tpu_torch.ops  # noqa: F401  (the kernels' custom ops)
    from picklebot_tpu_torch.core.policy import DtypePolicy

    meta = read_metadata(path)
    want = _device_key(device)
    if meta.get("device") != want:
        raise ValueError(f"artifact {path} was exported for "
                         f"{meta.get('device')!r}; this run serves on "
                         f"{want!r}. Export it again on {want!r} (an "
                         "artifact is bound to its device)")
    program = torch.export.load(str(path)).module()
    policy = (DtypePolicy.f32() if meta.get("compute_dtype") == "float32"
              else DtypePolicy.bf16())
    target = torch.device(want)

    def predict(features) -> np.ndarray:
        x = torch.as_tensor(np.ascontiguousarray(features)).to(target)
        with torch.no_grad(), policy.precision():
            return program(x).cpu().numpy()

    return predict, meta


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Export an AOT serving artifact (torch.export)")
    p.add_argument("config")
    p.add_argument("--checkpoint", required=True,
                   help="a .pth or a snapshot of the port's trainer")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=32)
    p.add_argument("--size", type=int, default=None,
                   help="spatial input size (default: config.input_size "
                        "if set, else 224). serve --exported host-resizes "
                        "mismatched clips to this")
    p.add_argument("--batch", type=int, default=-1,
                   help="-1 (default): symbolic batch dim; N: pinned")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights of a snapshot trained "
                        "with ema_decay > 0 instead of the raw weights")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu: "
                        "the artifact serves on this device only")
    args = p.parse_args(argv)

    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.convert import load_weights
    from picklebot_tpu_torch.utils.config import (load_config,
                                                  replicated_equivalent)
    from picklebot_tpu_torch.utils.devices import resolve_device

    config = replicated_equivalent(load_config(args.config))
    model = load_weights(args.checkpoint, initialize_model(config), args.ema)
    device = resolve_device(args.device)
    model = model.to(device)
    policy = DtypePolicy.bf16() if config.use_autocast else DtypePolicy.f32()
    mean = config.mean if config.apply_mean_std else None
    std = config.std if config.apply_mean_std else None
    # the model trained at config.input_size sees exactly that shape here;
    # serve --exported host-resizes any other clip to `size`
    size = args.size or config.input_size or 224
    image = config.model_name in IMAGE_MODELS
    program = export_predictor(
        model, policy, frames=args.frames, size=size, mean=mean, std=std,
        model_name=config.model_name,
        batch=None if args.batch == -1 else args.batch, device=device)
    meta = {
        "model_name": config.model_name,
        "num_classes": config.num_classes,
        "criterion": config.criterion,
        "frames": None if image else args.frames,
        "size": size,
        "batch": args.batch,
        # serve --exported strides its decode to this rate
        "sample_fps": config.sample_fps,
        "compute_dtype": str(policy.compute_dtype).replace("torch.", ""),
        "device": _device_key(device),
        "torch_version": torch.__version__,
        "input": ("uint8 (B, size, size, 3) RGB" if image
                  else "uint8 (B, frames, size, size, 3) RGB"),
        "output": "float32 logits (B, num_classes)",
    }
    save_artifact(args.out, program, meta)
    print(json.dumps({"exported": args.out, "device": meta["device"],
                      "batch": "symbolic" if args.batch == -1 else args.batch,
                      "bytes": os.path.getsize(args.out)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
