"""Threaded prefetching data loader and gradient-accumulation batching.

The port's own copy of ``DataLoader`` and ``accumulate_batches`` in
``picklebot_tpu/data/loader.py``: decode workers (threads; cv2 and numpy
release the GIL) fill a bounded queue, batches come out in order, collated
by ``pad_collate``. The shuffle is a permutation seeded by (seed, epoch)
through ``set_epoch``, as DistributedSampler does; ``drop_last`` skips the
tail's decode. ``skip(n)`` fast-forwards the next iteration past its first
n batches (a mid-epoch resume), and ``temporal_jitter`` takes a random
``max_frames`` window of a longer clip, keyed by (seed, epoch, dataset
index), so both give the JAX loader's batches bit for bit.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, List, Tuple

import numpy as np

from picklebot_tpu_torch.data.dataset import ClipDataset, pad_collate


class DataLoader:
    def __init__(self, dataset: ClipDataset, batch_size: int,
                 shuffle: bool = False, num_workers: int = 4,
                 t_bucket: int = 8, max_frames: int = 256,
                 seed: int = 1234, drop_last: bool = False,
                 prefetch_batches: int = 4, temporal_jitter: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.t_bucket = t_bucket
        self.max_frames = max_frames
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch_batches = prefetch_batches
        self.temporal_jitter = temporal_jitter
        self.epoch = 0
        self._skip_batches = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def skip(self, n_batches: int):
        """The next iteration starts at batch ``n_batches`` of its epoch:
        the skipped indices leave the permutation before any decode.
        One-shot."""
        self._skip_batches = max(0, int(n_batches))

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.RandomState((self.seed + self.epoch) % 2**31)
            rng.shuffle(idx)
        return idx

    def _window(self, item, ds_idx: int):
        """A clip longer than max_frames -> a random max_frames window,
        the JAX loader's draw on (seed, epoch, dataset index)."""
        clip, label = item
        rng = np.random.RandomState(
            (self.seed * 1000003 + self.epoch) * 1000003 % 2**31 ^ ds_idx)
        s = rng.randint(0, clip.shape[0] - self.max_frames + 1)
        return clip[s:s + self.max_frames], label

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        nb = len(self)
        order = self._order()[:nb * self.batch_size] if self.drop_last \
            else self._order()
        skip, self._skip_batches = min(self._skip_batches, nb), 0
        order, nb = order[skip * self.batch_size:], nb - skip
        item_q: "queue.Queue" = queue.Queue(
            maxsize=self.prefetch_batches * self.batch_size)
        stop = threading.Event()
        cursor = {"i": 0}
        cursor_lock = threading.Lock()

        def worker():
            while not stop.is_set():
                with cursor_lock:
                    i = cursor["i"]
                    if i >= len(order):
                        return
                    cursor["i"] = i + 1
                try:
                    ds_idx = int(order[i])
                    item = self.dataset[ds_idx]
                    if self.temporal_jitter and \
                            item[0].shape[0] > self.max_frames:
                        item = self._window(item, ds_idx)
                except Exception as e:  # surface decode errors, don't hang
                    item = e
                item_q.put((i, item))

        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending = {}
            next_idx = 0
            for b in range(nb):
                take = min(self.batch_size, len(order) - b * self.batch_size)
                clips, labels = [], []
                while len(clips) < take:
                    while next_idx not in pending:
                        i, item = item_q.get()
                        pending[i] = item
                    item = pending.pop(next_idx)
                    next_idx += 1
                    if isinstance(item, Exception):
                        raise item
                    clips.append(item[0])
                    labels.append(item[1])
                yield pad_collate(clips, labels, self.t_bucket,
                                  self.max_frames)
        finally:
            stop.set()
            # drain until every worker exits: workers blocked on a full
            # queue would otherwise never see the stop flag
            while any(t.is_alive() for t in threads):
                try:
                    item_q.get_nowait()
                except queue.Empty:
                    time.sleep(0.002)


def accumulate_batches(loader_iter, accum_steps: int):
    """Group ``accum_steps`` loader batches into one (A, B, T, H, W, C)
    super-batch, re-padding T to the group's longest; a final partial
    group is dropped (the reference never steps on it either)."""
    group_f: List[np.ndarray] = []
    group_l: List[np.ndarray] = []
    for feats, labels in loader_iter:
        group_f.append(feats)
        group_l.append(labels)
        if len(group_f) == accum_steps:
            t_max = max(f.shape[1] for f in group_f)
            group_f = [np.pad(f, ((0, 0), (0, t_max - f.shape[1]), (0, 0),
                                  (0, 0), (0, 0))) for f in group_f]
            yield np.stack(group_f), np.stack(group_l)
            group_f, group_l = [], []
