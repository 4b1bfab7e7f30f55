"""Clip dataset: CSV annotations + video decode, host-side numpy.

The port's own copy of ``picklebot_tpu/data/dataset.py``, all five of its
backends: ``synthetic``, ``synthetic_learnable``, ``npy``, ``opencv``
(``cv2`` is imported only when a clip is decoded) and ``ffmpeg`` (the C++
libav core of ``data/native.py``, built at its first decode). Synthetic
clips are byte-identical to the JAX package's: ``np.random.RandomState(
index)`` and T - index % 4 frames. ``pad_collate`` zero-pads T to a
bucket, with the native C++ collate where it builds and numpy otherwise
(``native.COLLATES`` counts each path). ``shard`` / ``num_shards`` keep
every ``num_shards``-th clip from ``shard`` on, truncated so that every
shard has the same length (data-parallel ranks must take the same number
of steps, so up to ``num_shards - 1`` clips of the tail are left out);
synthetic content stays keyed on the global index, so no two shards hold
the same clip.
"""

from __future__ import annotations

import os
import threading
import zipfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from picklebot_tpu_torch.data import native as native_core


def read_annotations(csv_path: str) -> Tuple[List[str], np.ndarray]:
    """CSV with ``filename`` and ``zone`` columns -> (names, labels)."""
    import csv
    names, zones = [], []
    with open(csv_path, newline="", encoding="ISO-8859-1") as f:
        for row in csv.DictReader(f):
            names.append(row["filename"])
            zones.append(int(float(row["zone"])))
    return names, np.asarray(zones, np.int64)


def sample_stride(native_fps: float, sample_fps: float) -> int:
    """Keep every k-th frame, k = round-half-up(native / sample fps)."""
    if sample_fps <= 0 or native_fps <= 0:
        return 1
    return max(1, int(native_fps / sample_fps + 0.5))


def decode_opencv(path: str, sample_fps: float = 0.0) -> np.ndarray:
    """Video file -> (T, H, W, 3) uint8 RGB."""
    import cv2
    cap = cv2.VideoCapture(path)
    stride = sample_stride(cap.get(cv2.CAP_PROP_FPS) or 0.0, sample_fps)
    frames = []
    i = 0
    while True:
        ret, frame = cap.read()
        if not ret:
            break
        if i % stride == 0:
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        i += 1
    cap.release()
    if not frames:
        raise IOError(f"no frames decoded from {path}")
    return np.stack(frames)


def decode_ffmpeg(path: str, sample_fps: float = 0.0) -> np.ndarray:
    """Video file -> (T, H, W, 3) uint8 RGB through the libavcodec core
    (``data/native_src/videodec.cpp``), byte-equal to ``decode_opencv``
    on the same files; the same ``sample_fps`` stride, computed in the
    core. Raises RuntimeError where the core cannot be built."""
    from picklebot_tpu_torch.data.native import decode_video_ffmpeg
    return decode_video_ffmpeg(path, sample_fps=sample_fps)


def decode_npy(path: str) -> np.ndarray:
    arr = np.load(path)
    if hasattr(arr, "files"):  # npz
        arr = arr[arr.files[0]]
    if arr.ndim != 4 or arr.shape[-1] != 3:
        raise ValueError(f"{path}: expected (T, H, W, 3), got {arr.shape}")
    return np.ascontiguousarray(arr, np.uint8)


class ClipDataset:
    BACKENDS = ("opencv", "ffmpeg", "npy", "synthetic",
                "synthetic_learnable")

    def __init__(self, annotations_file: str, video_dir: str,
                 backend: str = "opencv",
                 shard: int = 0, num_shards: int = 1,
                 synthetic_shape: Tuple[int, int, int] = (16, 224, 224),
                 synthetic_len: Optional[int] = None,
                 sample_fps: float = 0.0, synthetic_classes: int = 13,
                 skip_bad_clips: bool = False):
        if backend not in self.BACKENDS:
            raise ValueError(f"unknown data backend {backend!r} (valid: "
                             f"{', '.join(self.BACKENDS)})")
        self.video_dir = video_dir
        self.backend = backend
        self.sample_fps = float(sample_fps)
        self.synthetic_shape = synthetic_shape
        self.skip_bad_clips = bool(skip_bad_clips)
        self.bad_clips = 0
        self._bad_seen = set()
        self._bad_lock = threading.Lock()
        if backend.startswith("synthetic"):
            n = synthetic_len or 64
            self.filenames = [f"synthetic_{i}.mp4" for i in range(n)]
            self.labels = (np.arange(n) % max(1, synthetic_classes)
                           ).astype(np.int64)
            self._synthetic_n_cls = max(int(self.labels.max()) + 1, 1)
        else:
            self.filenames, self.labels = read_annotations(annotations_file)
        # the global index of each kept clip (synthetic content keys on it)
        self._ids = np.arange(len(self.filenames))
        if num_shards > 1:
            per_shard = len(self.filenames) // num_shards
            keep = slice(shard, None, num_shards)
            self.filenames = self.filenames[keep][:per_shard]
            self.labels = self.labels[keep][:per_shard]
            self._ids = self._ids[keep][:per_shard]

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, int]:
        if not self.skip_bad_clips:
            return self._decode_item(idx)
        # walk forward past undecodable clips, counting each
        for attempt in range(len(self.filenames)):
            j = (idx + attempt) % len(self.filenames)
            try:
                return self._decode_item(j)
            except (OSError, RuntimeError, ValueError,
                    zipfile.BadZipFile) as e:
                name = self.filenames[j]
                with self._bad_lock:
                    self.bad_clips += 1
                    warn = name not in self._bad_seen
                    self._bad_seen.add(name)
                if warn:
                    print(f"[dataset] skip_bad_clips: skipping {name} "
                          f"({type(e).__name__}: {e})")
        raise IOError(f"skip_bad_clips: no decodable clip in the dataset "
                      f"({len(self.filenames)} files, all failed)")

    def _decode_item(self, idx: int) -> Tuple[np.ndarray, int]:
        label = int(self.labels[idx])
        if self.backend.startswith("synthetic"):
            t, h, w = self.synthetic_shape
            gidx = int(self._ids[idx])
            rng = np.random.RandomState(gidx)
            t_i = max(1, t - (gidx % 4))    # vary T: exercises the buckets
            if self.backend == "synthetic_learnable":
                clip = (rng.randint(0, 100, (t_i, h, w, 3)) +
                        (label * 150) // self._synthetic_n_cls
                        ).astype(np.uint8)
            else:
                clip = rng.randint(0, 255, (t_i, h, w, 3)).astype(np.uint8)
            return clip, label
        path = os.path.join(self.video_dir, self.filenames[idx])
        if self.backend == "opencv":
            return decode_opencv(path, self.sample_fps), label
        if self.backend == "ffmpeg":
            return decode_ffmpeg(path, self.sample_fps), label
        return decode_npy(path), label


def bucket_frames(t: int, t_bucket: int, max_frames: int) -> int:
    """Round T up to the next bucket multiple, clamped to max_frames."""
    return min(-(-t // t_bucket) * t_bucket, max_frames)


def pad_collate(clips: Sequence[np.ndarray], labels: Sequence[int],
                t_bucket: int = 8, max_frames: int = 256,
                native: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad clips on T to a shared bucket (longer clips keep their
    head) and stack to (B, T, H, W, C) uint8: with ``native`` through the
    C++ collate (parallel memcpy, the GIL released), on numpy where it
    cannot be built or with ``native=False``. The bytes are the same
    either way."""
    shapes = {c.shape[1:] for c in clips}
    if len(shapes) > 1:
        raise ValueError(
            f"clips in one batch have mixed frame shapes {sorted(shapes)}; "
            "a mixed-resolution dataset needs offline normalization "
            "(scripts/preprocess_dataset.py --resize) — config.input_size "
            "resizes on device but batches must still stack uniformly")
    t_out = bucket_frames(max(c.shape[0] for c in clips), t_bucket,
                          max_frames)
    batch = np.zeros((len(clips), t_out) + clips[0].shape[1:], np.uint8)
    if native and native_core.native_collate(batch, clips):
        return batch, np.asarray(labels, np.int64)
    native_core.COLLATES["numpy"] += 1
    for i, clip in enumerate(clips):
        t_i = min(clip.shape[0], t_out)
        batch[i, :t_i] = clip[:t_i]
    return batch, np.asarray(labels, np.int64)
