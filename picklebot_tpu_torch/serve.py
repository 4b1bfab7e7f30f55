"""Inference CLI of the port: classify clips from a ``.pth`` checkpoint, a
snapshot of the port's trainer, or an exported program.

Counterpart of ``picklebot_tpu/serve.py``; the JSON lines it prints are
the same.

  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      clip1.mp4 clip2.mp4 ...
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      --csv annotations.csv [--limit N]    # accuracy over a CSV
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      --stream [--chunk N] clip.mp4        # online, one line per chunk
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint snap \
      --ema clip.mp4                       # a snapshot's EMA weights
  python -m picklebot_tpu_torch.serve --exported model.pt2 clip1.mp4 ...
      # the program of python -m picklebot_tpu_torch.export: no config,
      # no checkpoint, no model zoo at load time
  python -m picklebot_tpu_torch.serve <config.json> --checkpoint w.pth \
      --http 8000                          # or --exported m.pt2 --http 8000

``--http PORT`` serves ``POST /predict`` (body: a video file -> JSON
prediction), ``GET /`` (model and server info) and ``GET /healthz``
(request and error counters). Concurrent requests coalesce into one
predictor call per ``--batch-window`` ms (``RequestBatcher``), keyed on
(T bucket, H, W); the batch dim pads to a power of two.

``--stream`` serves the online models (MoViNetA2Stream with its stream
buffers, MobileNetLarge2D / MobileNetSmall2D with their LSTM state): each
clip runs in ``--chunk``-frame pieces (default 1) with the state carried
from one to the next, one JSON line per piece, ``frame`` the frames
consumed so far; a ragged tail runs frame by frame and gives one last
line. Without ``--stream`` these models classify whole clips from a zero
state.

``config.input_size`` resizes the decoded frames inside every predictor
call (``ops/resize.py``); ``--exported`` resizes on the host instead
(cv2, to the artifact's fixed size).

It runs on ``--device cuda`` (the default; an error if there is no card)
or ``--device cpu``. ``--data-parallel N`` shards each batch over N
replicas (``train.step.make_sharded_predict_fn``): ``cuda:0`` ... ``cuda:N-1``
(it exits non-zero, naming the count it found, on a machine with fewer
cards; it never serves on fewer), or N replicas on the CPU with ``--device
cpu``. A ragged batch pads to a multiple of N and is trimmed after.
MoViNetA2Stream, ``--stream`` and ``--exported`` refuse it.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from picklebot_tpu_torch.convert import load_weights
from picklebot_tpu_torch.data.dataset import bucket_frames, pad_collate

BALL_STRIKE = {0: "ball", 1: "strike"}


def _data_parallel_devices(n: int, device: str):
    """--data-parallel N on ``device``: the N cards cuda:0 .. cuda:N-1, or
    N CPU replicas; None (after saying why) where fewer cards exist."""
    import torch
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        print(f"--data-parallel {n} needs {n} CUDA cards; found {found} "
              "(pass --data-parallel <= the cards present)",
              file=sys.stderr)
        return None
    return [f"cuda:{i}" for i in range(n)]


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


class RequestBatcher:
    """Cross-request dynamic batching for HTTP serving.

    Concurrent ``POST /predict`` bodies are decoded in their handler
    threads and enqueued; one worker thread drains the queue into a single
    batch, waiting up to ``window_ms`` after the first clip arrives or
    until ``max_batch`` clips are pending, and runs the predictor once:
    the card wants wide batches, and a call per request would leave it
    idle between host round trips.

    Only requests with the same ``key`` share a batch (the checkpoint
    path keys on (T bucket, H, W)): different resolutions cannot stack,
    and sharing a T bucket with a longer clip would change a clip's
    padding, and with it its unmasked temporal pooling, making a
    prediction depend on concurrent traffic. A request of another key
    waits for the next batch. An error in the predictor reaches every
    waiter of that batch; the worker goes on.
    """

    def __init__(self, predict_batch, max_batch=8, window_ms=10.0):
        self._predict_batch = predict_batch   # list[clip] -> list[dict]
        self.max_batch = max(1, max_batch)
        self.window_s = window_ms / 1e3
        self._pending = []                    # [(key, clip, event, slot)]
        self._cv = threading.Condition()
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, clip, key=None):
        """Block until the clip's prediction dict is ready."""
        event = threading.Event()
        slot = {}
        with self._cv:
            self._pending.append((key, clip, event, slot))
            self._cv.notify()
        event.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["result"]

    def _take_matching(self, key, limit):
        """(lock held) pop up to ``limit`` pending entries with this key."""
        taken, rest = [], []
        for e in self._pending:
            if e[0] == key and len(taken) < limit:
                taken.append(e)
            else:
                rest.append(e)
        self._pending = rest
        return taken

    def _loop(self):
        while True:
            with self._cv:
                while not self._pending:
                    self._cv.wait()
                first = self._pending.pop(0)
            key = first[0]
            entries = [first]
            deadline = time.monotonic() + self.window_s
            while len(entries) < self.max_batch:
                with self._cv:
                    entries += self._take_matching(
                        key, self.max_batch - len(entries))
                    if len(entries) >= self.max_batch:
                        break
                    left = deadline - time.monotonic()
                    if left <= 0:
                        break
                    self._cv.wait(timeout=left)
            try:
                results = self._predict_batch([e[1] for e in entries])
                for (_, _, event, slot), rec in zip(entries, results):
                    slot["result"] = rec
                    event.set()
            except Exception as e:  # noqa: BLE001 -- to every waiter
                for _, _, event, slot in entries:
                    slot["error"] = e
                    event.set()


def make_http_server(port, classify_path, info, max_body=256 << 20,
                     request_timeout=120.0):
    """The HTTP endpoint: ``POST /predict`` with a video file as the body
    -> JSON prediction (``classify_path(spooled file path)``); ``GET /``
    -> ``info``; ``GET /healthz`` -> 200 with the request and error
    counters.

    Hostile input: a body over ``max_body`` bytes gets 413 before it is
    read (the Content-Length header is checked first; a missing one, as
    in a chunked upload, gets 411, a malformed one 400); an empty body
    400; a body that does not decode 400 with the error (never a 500); a
    failed spool write 503; decode and predict bounded by
    ``request_timeout`` seconds, 504 after (the worker thread is left to
    finish); a 60 s socket timeout for slow bodies. Every outcome counts
    once in ``/healthz``, a client that hangs up before reading its
    answer included. Returns the ThreadingHTTPServer (the caller runs
    ``serve_forever``)."""
    import concurrent.futures
    import http.server
    import os
    import tempfile

    stats = {"requests": 0, "errors": 0}
    stats_lock = threading.Lock()
    # one worker per request in flight, like the handler threads; a
    # timed-out classify keeps its worker until the decode returns
    pool = concurrent.futures.ThreadPoolExecutor()

    def count(error=False):
        with stats_lock:
            stats["requests"] += 1
            if error:
                stats["errors"] += 1

    class Handler(http.server.BaseHTTPRequestHandler):
        timeout = 60.0  # socket timeout: slow bodies end here

        def log_message(self, *a):  # predictions go to the client
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _safe_send(self, code, obj):
            # the outcome is counted already: a client that hung up must
            # not crash the handler or count the request twice
            try:
                self._send(code, obj)
            except OSError:
                self.close_connection = True

        def do_GET(self):
            if self.path == "/healthz":
                with stats_lock:
                    return self._safe_send(200, {"status": "ok", **stats})
            self._safe_send(200, info)

        def do_POST(self):
            if self.path != "/predict":
                return self._safe_send(404, {"error": "POST /predict"})
            length = self.headers.get("Content-Length")
            if length is None:
                count(error=True)
                return self._safe_send(
                    411, {"error": "Content-Length required"})
            try:
                n = int(length)
            except ValueError:
                count(error=True)
                self.close_connection = True
                return self._safe_send(
                    400, {"error": f"malformed Content-Length: {length!r}"})
            if n > max_body:
                # refused before reading; the connection closes so the
                # client cannot stream the body anyway
                count(error=True)
                self.close_connection = True
                return self._safe_send(
                    413, {"error": f"body {n} bytes exceeds "
                                   f"the {max_body}-byte cap"})
            if n <= 0:
                count(error=True)
                return self._safe_send(400, {"error": "empty body"})
            try:
                data = self.rfile.read(n)
            except OSError:  # socket timeout, or the client went away
                count(error=True)
                self.close_connection = True
                return
            fd, path = tempfile.mkstemp(suffix=".mp4")
            try:
                try:
                    with os.fdopen(fd, "wb") as f:
                        f.write(data)
                except OSError as e:  # disk full: the server's fault
                    count(error=True)
                    return self._safe_send(
                        503, {"error": f"spool write failed: {e}"})
                fut = pool.submit(classify_path, path)
                try:
                    result = fut.result(timeout=request_timeout)
                except concurrent.futures.TimeoutError:
                    count(error=True)
                    return self._safe_send(
                        504, {"error": f"request exceeded "
                                       f"{request_timeout:g}s"})
                except Exception as e:  # noqa: BLE001 -- to the client
                    count(error=True)
                    return self._safe_send(
                        400, {"error": f"{type(e).__name__}: {e}"})
                count()
                self._safe_send(200, result)
            finally:
                os.unlink(path)

    return http.server.ThreadingHTTPServer(("", port), Handler)


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
    if input_size:
        # the frames are resized in preprocess: the carry is at that size
        h = w = input_size
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


def exported_prep(clip, frames, size):
    """(T, H, W, 3) uint8 -> (frames, size, size, 3) for an exported
    program, whose shapes are fixed: other spatial sizes are resized on
    the host (cv2, INTER_AREA on downscale, the nearest of its kernels to
    the antialiased in-graph resize, INTER_LINEAR on upscale), then T is
    trimmed or zero-padded to ``frames``."""
    if clip.shape[1] != size or clip.shape[2] != size:
        import cv2
        interp = (cv2.INTER_AREA if clip.shape[1] > size
                  else cv2.INTER_LINEAR)
        clip = np.stack([cv2.resize(f, (size, size), interpolation=interp)
                         for f in clip])
    clip = clip[:frames]
    if clip.shape[0] < frames:
        clip = np.concatenate(
            [clip, np.zeros((frames - clip.shape[0],) + clip.shape[1:],
                            np.uint8)])
    return clip


def records_fn(predict, config, max_batch):
    """The checkpoint path's batch function: uint8 clips (T, H, W, 3) ->
    per-clip prediction dicts, for the CLI, the CSV and HTTP alike. Clips
    of different (H, W) cannot stack, so they run as same-shape groups
    (with ``config.input_size`` each group resizes to the same model
    input); T pads to the config's bucket and the batch dim to a power of
    two (at most ``max_batch`` unless more clips are given)."""
    def predict_records(batch_clips):
        groups = {}
        for i, c in enumerate(batch_clips):
            groups.setdefault(c.shape[1:3], []).append(i)
        records = [None] * len(batch_clips)
        for idxs in groups.values():
            feats, _ = pad_collate([batch_clips[i] for i in idxs],
                                   [0] * len(idxs),
                                   config.t_bucket, config.max_frames)
            feats, b = pad_batch_to(
                feats, pad_batch_pow2(feats.shape[0], max_batch))
            logits = predict(feats)[:b]
            for i, rec in zip(idxs, decode_logits(
                    logits, config.criterion, config.num_classes)):
                records[i] = rec
        return records

    return predict_records


def batch_key(clip, config):
    """The checkpoint path's ``RequestBatcher`` key: (T bucket, H, W).
    Mixed resolutions cannot stack, and sharing a T bucket with a longer
    clip would change this clip's padding."""
    return (bucket_frames(clip.shape[0], config.t_bucket, config.max_frames),
            clip.shape[1], clip.shape[2])


def pinned_batch(meta):
    """An exported program's pinned batch, or None for a symbolic one."""
    pinned = meta.get("batch", -1)
    return pinned if isinstance(pinned, int) and pinned > 0 else None


def exported_records_fn(predict, meta, max_batch):
    """The exported path's batch function: clips already at the program's
    (frames, size, size, 3) -> per-clip prediction dicts, the batch dim
    padded to the pinned batch or to a power of two."""
    pinned = pinned_batch(meta)

    def predict_records(clips):
        feats = np.stack(clips)
        target = pinned or pad_batch_pow2(feats.shape[0], max_batch)
        if feats.shape[0] > target:
            raise ValueError(f"batch {feats.shape[0]} exceeds the "
                             f"artifact's pinned batch {target}")
        feats, b = pad_batch_to(feats, target)
        return decode_logits(predict(feats)[:b], meta["criterion"],
                             meta["num_classes"])

    return predict_records


def _serve_http(args, classify_path, info):
    srv = make_http_server(args.http, classify_path, info,
                           max_body=int(args.max_request_mb * 2 ** 20),
                           request_timeout=args.request_timeout)
    print(json.dumps({"serving": f"http://0.0.0.0:{srv.server_address[1]}"}),
          flush=True)
    srv.serve_forever()
    return 0


def _serve_exported(args):
    """Serve from an exported program (``export.py``): its weights inside,
    no config, no checkpoint, no model zoo at load time."""
    from picklebot_tpu_torch.data.dataset import decode_opencv
    from picklebot_tpu_torch.export import load_artifact
    from picklebot_tpu_torch.utils.devices import resolve_device

    predict, meta = load_artifact(args.exported, resolve_device(args.device))
    if meta.get("model_name") == "MobileViTV2":
        # an image classifier: the program takes (B, H, W, 3) frames, not
        # clips, so serve's mp4 contract does not apply
        print("--exported serving is clip-based; MobileViTV2 artifacts "
              "take single images (use picklebot_tpu_torch.export."
              "load_artifact)", file=sys.stderr)
        return 1
    frames, size = meta["frames"], meta["size"]
    num_classes, criterion = meta["num_classes"], meta["criterion"]
    sample_fps = float(meta.get("sample_fps", 0.0) or 0.0)
    pinned = pinned_batch(meta)

    def prep(path):
        return exported_prep(decode_opencv(path, sample_fps), frames, size)

    if args.http is not None:
        batcher = RequestBatcher(
            exported_records_fn(predict, meta, args.batch),
            max_batch=pinned or args.batch, window_ms=args.batch_window)
        return _serve_http(args, lambda path: batcher.submit(prep(path)),
                           {"mode": "exported", **meta})

    if not args.clips:
        print("no clips given", file=sys.stderr)
        return 1
    # a pinned artifact takes its batch only: chunk to it, pad the tail
    step_b = min(args.batch, pinned) if pinned else args.batch
    for start in range(0, len(args.clips), step_b):
        names = args.clips[start:start + step_b]
        feats = np.stack([prep(c) for c in names])
        if pinned:
            feats, b = pad_batch_to(feats, pinned)
        else:
            b = feats.shape[0]
        for name, rec in zip(names, decode_logits(predict(feats)[:b],
                                                  criterion, num_classes)):
            print(json.dumps({"clip": name, **rec}))
    return 0


def _unsupported(mode, hint, flags):
    """rc 1 with the JAX server's message when ``mode`` meets any of the
    ``flags`` that are set; None otherwise."""
    on = [f for f, is_set in flags if is_set]
    if on:
        print(f"{mode} does not support {', '.join(on)} ({hint} for those "
              "modes)", file=sys.stderr)
        return 1
    return None


def main(argv=None):
    p = argparse.ArgumentParser(description="Classify pitch clips")
    p.add_argument("config", nargs="?", default=None)
    p.add_argument("clips", nargs="*")
    p.add_argument("--checkpoint", default=None,
                   help="torch .pth with the reference keys, or a snapshot "
                        "of the port's trainer")
    p.add_argument("--exported", default=None,
                   help="program from python -m picklebot_tpu_torch.export "
                        "(replaces config + --checkpoint)")
    p.add_argument("--csv", default=None,
                   help="annotation csv: evaluate accuracy instead")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--stream", action="store_true",
                   help="online mode: carried state, one prediction per "
                        "chunk (MoViNetA2Stream / MobileNet*2D)")
    p.add_argument("--chunk", type=int, default=1,
                   help="frames per streaming step (--stream)")
    p.add_argument("--http", type=int, default=None, metavar="PORT",
                   help="serve over HTTP instead: POST /predict with a "
                        "video file body -> JSON prediction (0 = any port)")
    p.add_argument("--data-parallel", type=int, default=1, metavar="N",
                   help="shard each inference batch over N cards "
                        "(cuda:0 .. cuda:N-1; N replicas with --device "
                        "cpu)")
    p.add_argument("--batch-window", type=float, default=10.0, metavar="MS",
                   help="--http cross-request batching: wait up to MS ms "
                        "after the first request to coalesce up to --batch "
                        "clips into one predictor call (0 = no batching)")
    p.add_argument("--max-request-mb", type=float, default=256.0,
                   help="--http: reject POST bodies larger than this "
                        "(413; checked before reading)")
    p.add_argument("--request-timeout", type=float, default=600.0,
                   help="--http: bound decode+predict per request in "
                        "seconds (504 on expiry)")
    p.add_argument("--ema", action="store_true",
                   help="serve the EMA weights of a snapshot trained with "
                        "ema_decay > 0")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    if args.exported is not None:
        # whole fixed-shape clips only: CSV evaluation, chunked streaming
        # and sharding need the live model and config
        rc = _unsupported("--exported", "use <config> --checkpoint", (
            ("--csv", args.csv is not None), ("--stream", args.stream),
            ("--data-parallel", args.data_parallel > 1)))
        if rc is not None:
            return rc
        # without a config the first positional is a clip
        if args.config is not None:
            args.clips = [args.config] + args.clips
        return _serve_exported(args)
    if args.config is None or args.checkpoint is None:
        print("need <config> and --checkpoint (or --exported)",
              file=sys.stderr)
        return 1

    from picklebot_tpu_torch.core.policy import DtypePolicy
    from picklebot_tpu_torch.data.dataset import ClipDataset, decode_opencv
    from picklebot_tpu_torch.models.registry import initialize_model
    from picklebot_tpu_torch.train.step import (make_predict_fn,
                                                make_sharded_predict_fn)
    from picklebot_tpu_torch.utils.config import (load_config,
                                                  replicated_equivalent)
    from picklebot_tpu_torch.utils.devices import resolve_device

    dp_devices = None
    if args.data_parallel > 1 and not args.stream:
        dp_devices = _data_parallel_devices(args.data_parallel, args.device)
        if dp_devices is None:
            return 1
    device = resolve_device(args.device)
    config = replicated_equivalent(load_config(args.config))
    if args.stream:
        # a CLI-only mode (per-clip carried state)
        rc = _unsupported("--stream", "drop --stream", (
            ("--http", args.http is not None), ("--csv", args.csv is not None),
            ("--data-parallel", args.data_parallel > 1)))
        if rc is not None:
            return rc
        if config.model_name not in STREAM_MODELS:
            print(f"--stream needs one of {STREAM_MODELS} "
                  f"(got {config.model_name})", file=sys.stderr)
            return 1
        if not args.clips:
            print("no clips given", file=sys.stderr)
            return 1
    elif dp_devices is not None and config.model_name == "MoViNetA2Stream":
        print("--data-parallel does not support MoViNetA2Stream "
              "(stream-buffer carry)", file=sys.stderr)
        return 1
    model = load_weights(args.checkpoint, initialize_model(config),
                         args.ema).to(device)
    policy = DtypePolicy.bf16() if config.use_autocast else DtypePolicy.f32()
    mean = config.mean if config.apply_mean_std else None
    std = config.std if config.apply_mean_std else None
    # clips decode at native resolution; config.input_size resizes them
    # inside the predictor (ops/resize.py)
    if dp_devices is not None:
        predict = make_sharded_predict_fn(model, dp_devices, policy,
                                          mean=mean, std=std,
                                          input_size=config.input_size)
    else:
        predict = make_predict_fn(model, policy, mean=mean, std=std,
                                  input_size=config.input_size,
                                  device=device)

    def decode(path):
        return decode_opencv(path, config.sample_fps)

    if args.stream:
        for clip in args.clips:
            for rec, _ in stream_clip(model, decode(clip), args.chunk,
                                      policy, device, config.criterion,
                                      config.num_classes, mean=mean,
                                      std=std, input_size=config.input_size):
                print(json.dumps({"clip": clip, **rec}))
        return 0

    predict_records = records_fn(predict, config, args.batch)

    def classify(batch_clips, names):
        recs = predict_records(batch_clips)
        for name, rec in zip(names, recs):
            print(json.dumps({"clip": name, **rec}))
        return np.array([r["pred"] for r in recs])

    if args.http is not None:
        batcher = RequestBatcher(predict_records, max_batch=args.batch,
                                 window_ms=args.batch_window)

        def classify_path(path):
            clip = decode(path)
            return batcher.submit(clip, key=batch_key(clip, config))

        return _serve_http(args, classify_path,
                           {"mode": "checkpoint",
                            "model_name": config.model_name,
                            "num_classes": config.num_classes,
                            "criterion": config.criterion})

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
        classify([decode(c) for c in chunk], chunk)
    return 0


if __name__ == "__main__":
    sys.exit(main())
