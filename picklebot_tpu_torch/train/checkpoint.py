"""The port's full-state training snapshots, and transfer-learning grafts.

Counterpart of the Orbax half of ``picklebot_tpu/train/checkpoint.py``,
without Orbax: one ``torch.save`` file per snapshot, written under a
temporary name and renamed, so a torn write is never taken for a
snapshot. A snapshot holds

  * ``model``: the state dict (weights and BatchNorm buffers, the
    reference keys), ``ema``: the EMA weights or None,
  * ``optimizer``: ``AdamW.state_dict()`` (f32 moments, 8-bit (codes,
    scales) pairs, ``steps``), ``epoch``: the next epoch to run,
  * ``loop_state``: int64 [global step, optimizer steps into the epoch],
  * ``early_stop``: float64 [best val loss, patience baseline, evals
    since the last improvement] (float64 so that inf survives).

Names and layout are the JAX package's: ``{checkpoint_dir}/{model_name}/
step_<e>`` after epoch e's eval and ``step_<e>_<n>`` after n optimizer
steps of epoch e, ``{model_name}_best/`` and ``{run_name}_finished/``;
``latest_checkpoint`` ranks them, ``prune_epochs`` and ``prune_midepoch``
keep the newest; ``SnapshotWriter`` writes them, on a background thread
with ``async_checkpoint``. In a data-parallel run rank 0 alone writes and
prunes (the trainer's other ranks wait at a barrier after a blocking
write); a ZeRO run's optimizer state is stored stacked by rank (see
``snapshot``) and resharded for the resuming run's degree. Orbax snapshots
stay the JAX package's (its ``python -m picklebot_tpu.convert`` exports
their weights as a ``.pth``). Under tensor parallelism a snapshot is a
collective over 'model' too: it holds full leaves (each FFN shard
gathered, ``full_state_dict``) and the optimizer state in the JAX TP
layout (``parallel/megatron.gather_optimizer_state``), so it, and the
``.pth`` of such a run, loads into one process as it is; a resume cuts
them again for its own ranks. Expert parallelism does the same over
'expert' for the MoE banks' ``w1`` / ``w2`` (one layout mechanism,
``megatron.SHARD_RULES`` and each module's ``sharded``).
"""

from __future__ import annotations

import os
import re
import shutil
import threading
import zipfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SNAPSHOT_FORMAT = "picklebot_tpu_torch.snapshot.v1"


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().cpu().clone()


def snapshot(model, optimizer, ema, epoch: int, loop_state,
             early_stop, zero=None) -> dict:
    """The host copy of the whole training state (taken before any
    background write starts, so training may go on meanwhile). Under
    ZeRO (``zero``, a ``parallel.zero.ZeroLayout``) it is a collective
    that every rank enters: the optimizer state is gathered into the
    (n, chunk) rank-stack layout and, at stage 3, the parameters and the
    EMA into full leaves, so that a snapshot never depends on the run's
    stage (``zero_degree_of`` reads its degree back)."""
    from picklebot_tpu_torch.parallel import megatron
    from picklebot_tpu_torch.parallel import zero as zero_mod
    if zero is None:
        opt_state = megatron.gather_optimizer_state(optimizer, model)
    else:
        opt_state = zero_mod.gather_optimizer_state(zero, optimizer)
        if ema is not None and zero.stage == 3:
            ema = zero_mod.zero3_unshard_params(
                zero, [ema[k] for k in zero.names])
    if ema is not None:
        ema = _gather_tp(model, ema)
    with zero_mod.gathered(zero):
        weights = {k: _host(v) for k, v in full_state_dict(model).items()}
    return {"format": SNAPSHOT_FORMAT,
            "model": weights,
            "ema": None if ema is None else {k: _host(v)
                                             for k, v in ema.items()},
            "optimizer": opt_state,
            "epoch": int(epoch),
            "loop_state": torch.as_tensor(np.asarray(loop_state, np.int64)),
            "early_stop": torch.as_tensor(np.asarray(early_stop,
                                                     np.float64))}


def _gather_tp(model, tensors: Dict[str, torch.Tensor]):
    """``tensors`` ({state-dict key: tensor}) with every sharded one (TP
    over 'model', EP over 'expert') gathered over its axis (a
    collective); the rest as they are."""
    from picklebot_tpu_torch.parallel.megatron import gather_tensor, layout
    lay = layout(model)
    return {k: v if k not in lay else gather_tensor(v, lay[k][1], lay[k][0])
            for k, v in tensors.items()}


def full_state_dict(model) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with full leaves: under tensor or expert
    parallelism each shard gathered over its axis (a collective every
    rank of the group enters); otherwise the state dict itself."""
    return _gather_tp(model, model.state_dict())


def _write(payload: dict, path: str):
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp{os.getpid()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class SnapshotWriter:
    """Writes snapshots, one at a time: ``save`` with ``block=False``
    writes on a background thread and returns; the next ``save``, or
    ``wait``, waits for it and raises the error it met."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def _background(self, payload, path):
        try:
            _write(payload, path)
        except Exception as e:          # raised again by wait()
            self._error = e

    def save(self, directory: str, step: int, payload: dict,
             block: bool = True, minor: Optional[int] = None) -> str:
        """Write ``payload`` as ``directory/step_<step>`` (``step_<step>_
        <minor>`` mid-epoch)."""
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        name = f"step_{step}" if minor is None else f"step_{step}_{minor}"
        path = os.path.join(directory, name)
        self.wait()
        if block:
            _write(payload, path)
        else:
            self._thread = threading.Thread(
                target=self._background, args=(payload, path), daemon=True)
            self._thread.start()
        return path

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise RuntimeError("a background snapshot write failed") \
                from error


def is_snapshot(path: str) -> bool:
    """A file that ``SnapshotWriter`` wrote (torch.save's zip format)."""
    return os.path.isfile(path) and zipfile.is_zipfile(path)


def load_checkpoint(path: str) -> dict:
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or \
            payload.get("format") != SNAPSHOT_FORMAT:
        raise ValueError(f"{path} is not a snapshot of the PyTorch "
                         f"trainer (format {SNAPSHOT_FORMAT})")
    return payload


def _snapshots(directory: str, pattern: str) -> List[Tuple[tuple, str]]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        m = re.fullmatch(pattern, name)
        if m:
            out.append((tuple(int(g) for g in m.groups()), name))
    return sorted(out)


def _remove(path: str):
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    elif os.path.exists(path):
        os.remove(path)


def prune_epochs(directory: str, keep: int) -> None:
    """Delete all but the newest ``keep`` end-of-epoch snapshots
    (``step_<e>``); ``keep`` <= 0 keeps every one."""
    if keep <= 0:
        return
    snaps = _snapshots(directory, r"step_(\d+)")
    for _, name in snaps[:max(0, len(snaps) - keep)]:
        _remove(os.path.join(directory, name))


def prune_midepoch(directory: str, keep: int = 1) -> None:
    """Delete all but the newest ``keep`` mid-epoch snapshots
    (``step_<e>_<n>``); end-of-epoch ones are never touched. A write in
    flight has its temporary name and is not seen."""
    snaps = _snapshots(directory, r"step_(\d+)_(\d+)")
    for _, name in snaps[:max(0, len(snaps) - keep)]:
        _remove(os.path.join(directory, name))


def latest_checkpoint(directory: str) -> Optional[str]:
    """The newest snapshot in ``directory`` by training progress: an
    end-of-epoch ``step_<e>`` outranks every ``step_<e>_<n>`` of its
    epoch, and a later epoch outranks an earlier one."""
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        m = re.fullmatch(r"step_(\d+)(?:_(\d+))?", name)
        if not m:
            continue
        key = (int(m.group(1)),
               int(m.group(2)) if m.group(2) else float("inf"))
        if best is None or key > best[0]:
            best = (key, name)
    return None if best is None else os.path.join(directory, best[1])


def graft_matching(donor: Dict[str, torch.Tensor],
                   fresh: Dict[str, torch.Tensor]):
    """Transfer-learning merge of two state dicts: each donor tensor whose
    key exists in ``fresh`` with the same shape replaces the fresh one
    (cast to its dtype); everything else keeps the fresh value. Returns
    (merged, grafted keys, [(skipped key, reason)]), by the rule of the
    JAX package's ``graft_matching``."""
    merged = dict(fresh)
    grafted, skipped = [], []
    for key in sorted(donor):
        if key not in fresh:
            skipped.append((key, "no matching leaf in the fresh model"))
            continue
        src, tgt = donor[key], fresh[key]
        if tuple(src.shape) != tuple(tgt.shape):
            skipped.append((key, f"donor shape {tuple(src.shape)} != fresh "
                                 f"{tuple(tgt.shape)}"))
            continue
        merged[key] = src.to(tgt.dtype)
        grafted.append(key)
    return merged, grafted, skipped
