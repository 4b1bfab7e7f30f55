"""Inference CLI of the port: classify clips from a ``.pth`` checkpoint.

Counterpart of the checkpoint mode of ``picklebot_tpu/serve.py``; the JSON
lines it prints are the same.

  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      clip1.mp4 clip2.mp4 ...
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      --csv annotations.csv [--limit N]    # accuracy over a CSV
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      --stream [--chunk N] clip.mp4        # online, one line per chunk

``--stream`` serves the online models (MoViNetA2Stream with its stream
buffers, MobileNetLarge2D / MobileNetSmall2D with their LSTM state): each
clip runs in ``--chunk``-frame pieces (default 1) with the state carried
from one to the next, one JSON line per piece, ``frame`` the frames
consumed so far; a ragged tail runs frame by frame and gives one last
line. Without ``--stream`` these models classify whole clips from a zero
state.

It runs on ``--device cuda`` (the default; an error if there is no card)
or ``--device cpu``. ``--http``, ``--exported``, ``--data-parallel`` and
``--ema`` are queued in ROADMAP.md.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

BALL_STRIKE = {0: "ball", 1: "strike"}


def decode_logits(logits, criterion, num_classes):
    """f32 logits (B, C) -> per-clip {pred, label, confidence} dicts."""
    if criterion == "BCE":
        prob1 = 1.0 / (1.0 + np.exp(-logits[:, 0]))
        preds = (prob1 >= 0.5).astype(np.int64)
        confs = np.where(preds == 1, prob1, 1.0 - prob1)
    else:
        e = np.exp(logits - logits.max(-1, keepdims=True))
        probs = e / e.sum(-1, keepdims=True)
        preds = logits.argmax(-1)
        confs = probs[np.arange(len(preds)), preds]
    out = []
    for pr, cf in zip(preds, confs):
        label = (BALL_STRIKE.get(int(pr), f"zone_{int(pr)}")
                 if num_classes <= 2 else f"zone_{int(pr)}")
        out.append({"pred": int(pr), "label": label,
                    "confidence": round(float(cf), 4)})
    return out


def pad_batch_pow2(n, max_batch):
    """Batch-dim bucket: next power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max(max_batch, n))


def pad_batch_to(feats, target):
    """Zero-pad the leading (batch) dim to ``target``; returns (padded,
    original_b) so callers can trim predictions back."""
    b = feats.shape[0]
    if target > b:
        feats = np.concatenate(
            [feats, np.zeros((target - b,) + feats.shape[1:], feats.dtype)])
    return feats, b


STREAM_MODELS = ("MoViNetA2Stream", "MobileNetLarge2D", "MobileNetSmall2D")


def stream_clip(model, frames, chunk, policy, device, criterion,
                num_classes, mean=None, std=None, input_size=None):
    """Online prediction over one decoded clip: uint8 frames (T, H, W, 3)
    go through ``model`` (one of STREAM_MODELS, in eval mode on
    ``device``) in ``chunk``-frame pieces with the carried state starting
    at zero in the compute dtype. Yields, per piece, its record ({"frame",
    "pred", "label", "confidence"}, frame = frames consumed so far) and its
    f32 logits (1, num_classes).

    A ragged tail runs frame by frame and yields once, at frame = T, as in
    the JAX server: MoViNetA2Stream's SE blocks pool over the frames of the
    piece at hand, so a tail run as one piece would give other logits."""
    import torch

    from picklebot_tpu_torch.train.step import preprocess

    dtype = policy.compute_dtype
    t_total, h, w = frames.shape[:3]
    tail = t_total % chunk
    pieces = [(s, chunk) for s in range(0, t_total - tail, chunk)]
    pieces += [(s, 1) for s in range(t_total - tail, t_total)]
    with torch.inference_mode(), policy.precision():
        carry = model.init_stream(1, h, w, dtype, device)
        for start, size in pieces:
            piece = np.ascontiguousarray(frames[None, start:start + size])
            x = preprocess(torch.from_numpy(piece).to(device), dtype, mean,
                           std, input_size)
            logits, carry = model(x, carry)
            if start < t_total - tail or start == t_total - 1:
                # every whole chunk, and the tail's last frame
                logits = logits.float().cpu().numpy()
                rec = decode_logits(logits, criterion, num_classes)[0]
                yield {"frame": start + size, **rec}, logits


def main(argv=None):
    p = argparse.ArgumentParser(description="Classify pitch clips")
    p.add_argument("config")
    p.add_argument("clips", nargs="*")
    p.add_argument("--checkpoint", required=True,
                   help="torch .pth with the reference keys")
    p.add_argument("--csv", default=None,
                   help="annotation csv: evaluate accuracy instead")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--stream", action="store_true",
                   help="online mode: carried state, one prediction per "
                        "chunk (MoViNetA2Stream / MobileNet*2D)")
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per streaming step (--stream)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if not args.checkpoint.endswith(".pth"):
        print("the port serves .pth checkpoints only (Orbax snapshots: "
              "convert with python -m picklebot_tpu.convert)",
              file=sys.stderr)
        return 1

    from picklebot_tpu_torch.convert import load_pth
    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.data.dataset import (ClipDataset, decode_opencv,
                                                  pad_collate)
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train.step import make_predict_fn
    from picklebot_tpu_torch.utils.config import (load_config,
                                                  replicated_equivalent)
    from picklebot_tpu_torch.utils.devices import resolve_device

    device = resolve_device(args.device)
    config = replicated_equivalent(load_config(args.config))
    if args.stream:
        # streaming is a CLI-only mode (per-clip carried state)
        if args.csv is not None:
            print("--stream does not support --csv (drop --stream for "
                  "those modes)", file=sys.stderr)
            return 1
        if config.model_name not in STREAM_MODELS:
            print(f"--stream needs one of {STREAM_MODELS} "
                  f"(got {config.model_name})", file=sys.stderr)
            return 1
        if not args.clips:
            print("no clips given", file=sys.stderr)
            return 1
    model = load_pth(args.checkpoint, initialize_model(config)).to(device)
    policy = DtypePolicy.bf16() if config.use_autocast else DtypePolicy.f32()
    mean = config.mean if config.apply_mean_std else None
    std = config.std if config.apply_mean_std else None
    predict = make_predict_fn(model, policy, mean=mean, std=std,
                              input_size=config.input_size, device=device)

    if args.stream:
        for clip in args.clips:
            frames = decode_opencv(clip, config.sample_fps)
            for rec, _ in stream_clip(model, frames, args.chunk, policy,
                                      device, config.criterion,
                                      config.num_classes, mean=mean,
                                      std=std, input_size=config.input_size):
                print(json.dumps({"clip": clip, **rec}))
        return 0

    def predict_records(batch_clips):
        """clips -> per-clip prediction dicts. Clips of different (H, W)
        cannot stack, so they run as same-shape groups; the batch dim pads
        to a power of two as in the JAX server."""
        groups = {}
        for i, c in enumerate(batch_clips):
            groups.setdefault(c.shape[1:3], []).append(i)
        records = [None] * len(batch_clips)
        for idxs in groups.values():
            feats, _ = pad_collate([batch_clips[i] for i in idxs],
                                   [0] * len(idxs),
                                   config.t_bucket, config.max_frames)
            feats, b = pad_batch_to(
                feats, pad_batch_pow2(feats.shape[0], args.batch))
            logits = predict(feats)[:b]
            for i, rec in zip(idxs, decode_logits(
                    logits, config.criterion, config.num_classes)):
                records[i] = rec
        return records

    def classify(batch_clips, names):
        recs = predict_records(batch_clips)
        for name, rec in zip(names, recs):
            print(json.dumps({"clip": name, **rec}))
        return np.array([r["pred"] for r in recs])

    if args.csv:
        ds = ClipDataset(args.csv, config.video_paths,
                         backend=config.data_backend,
                         synthetic_shape=config.synthetic_shape,
                         synthetic_len=config.synthetic_len,
                         sample_fps=config.sample_fps,
                         synthetic_classes=config.resolved_synthetic_classes(),
                         skip_bad_clips=config.skip_bad_clips)
        n = min(len(ds), args.limit or len(ds))
        correct = 0
        for start in range(0, n, args.batch):
            idxs = range(start, min(start + args.batch, n))
            clips, labels = zip(*[ds[i] for i in idxs])
            preds = classify(list(clips), [ds.filenames[i] for i in idxs])
            correct += int((preds == np.asarray(labels)).sum())
        print(json.dumps({"evaluated": n, "accuracy": correct / max(n, 1)}))
        return 0
    if not args.clips:
        print("no clips given", file=sys.stderr)
        return 1
    for start in range(0, len(args.clips), args.batch):
        chunk = args.clips[start:start + args.batch]
        classify([decode_opencv(c, config.sample_fps) for c in chunk], chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
