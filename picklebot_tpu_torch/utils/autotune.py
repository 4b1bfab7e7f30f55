"""Measurement-driven choice of cuDNN's algorithm search, cached.

Counterpart of ``picklebot_tpu/utils/autotune.py``, which is itself the
analog of the reference's ``cudnn.benchmark = True`` unless
``varying_input_size`` (reference train.py:193-194). The JAX autotuner
chooses among exact fold plans, which the port does not carry; the port's
exact choice is the reference's own: ``torch.backends.cudnn.benchmark``
off (cuDNN's heuristic picks each convolution's algorithm) or on (cuDNN
times its algorithms at the first call of each shape and keeps the
fastest). Either gives the same function; which is faster for a workload
is measured, not derived. No candidate moves a hand-written kernel's work
to a library: the flag only changes how cuDNN runs the convolutions that
are cuDNN's already.

  * ``autotune(config, mode, device)``: measure both candidates on the
    device at the configured shape with the bench's ``Workload`` (CUDA
    events on the card, the host clock on the CPU), after warm-up calls
    that take cuDNN's search out of the timing, and return the winner.
    Verdicts persist in a JSON cache (``PICKLEBOT_AUTOTUNE_CACHE``, else
    ``~/.cache/picklebot_tpu_torch/autotune.json``) keyed by the card's
    name and cuDNN version, model and architecture, shape, mode, dtype,
    classes, optimizer and remat. A candidate that fails is recorded and
    skipped, and retried on a later call; if both fail the call raises.
    A process that asks for deterministic algorithms has one candidate
    (the search off) and measures nothing.
  * ``autotune_config(config, mode, device)``: the ``train()`` entry.
    ``varying_input_size`` skips the search, as it keeps the reference's
    flag off. Returns the config with ``autotune`` off and the flag to
    apply (None: leave it); ``train()`` sets it for the run and restores
    it after (``cudnn_benchmark``).

Data-parallel runs (a ``torch.distributed`` group, ``parallel/mesh.py``):
rank 0 alone measures and broadcasts the index of its winner in
``candidates()``, so that every rank runs the same flag; if its search
raises, it broadcasts -1 instead, and every rank raises (rank 0 its own
error) rather than leave the others waiting in a collective.

CLI: ``python -m picklebot_tpu_torch.utils.autotune <config.json> [--mode
infer] [--batch N --frames T --size S] [--device cpu]`` prints each
candidate's measurement and writes the cache other entry points hit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import List, Optional, Tuple

import torch


def candidates() -> List[bool]:
    """The values of ``cudnn.benchmark`` to measure: off and on, or off
    alone under deterministic algorithms (a timed search may pick a
    different algorithm from one run to the next)."""
    if torch.are_deterministic_algorithms_enabled() or \
            torch.backends.cudnn.deterministic:
        return [False]
    return [False, True]


def candidate_name(benchmark: bool) -> str:
    return "benchmark_on" if benchmark else "benchmark_off"


@contextlib.contextmanager
def cudnn_benchmark(benchmark: Optional[bool]):
    """``torch.backends.cudnn.benchmark`` set to ``benchmark`` within the
    block and restored after, also on an error; None leaves it."""
    if benchmark is None:
        yield
        return
    prev = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = benchmark
    try:
        yield
    finally:
        torch.backends.cudnn.benchmark = prev


def _cache_path() -> str:
    return os.environ.get(
        "PICKLEBOT_AUTOTUNE_CACHE",
        os.path.expanduser("~/.cache/picklebot_tpu_torch/autotune.json"))


def _load_cache(path: str) -> dict:
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return {}


def _save_cache(path: str, cache: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(cache, fh, indent=1, sort_keys=True)
    os.replace(tmp, path)


def _tune_shape(config, mode: str) -> Tuple[int, ...]:
    """The device-input shape measured: ``batch_size``, and the clip
    geometry of ``autotune_shape`` (T, H, W) when given, else
    ``synthetic_shape`` (the actual shape for the synthetic backends).
    For video data of another geometry set ``autotune_shape``: a tune at
    another shape risks a slower flag, never a wrong result."""
    b = config.batch_size
    t, h, w = config.autotune_shape or config.synthetic_shape
    if config.model_name == "MobileViTV2":      # image model: (B, H, W, C)
        return (b, h, w, 3)
    return (b, t, h, w, 3)


def _device_kind(device) -> str:
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    # algorithm choice and speed depend on cuDNN's version as on the card
    return (f"cuda:{torch.cuda.get_device_name(device)}:"
            f"cudnn{torch.backends.cudnn.version()}")


def _cache_key(config, mode: str, shape: Tuple[int, ...], device) -> str:
    dtype = "bf16" if config.use_autocast else "f32"
    # every knob that changes the measured program is in the key:
    # MobileViT's variants share model_name and differ in dims/channels
    arch = []
    if config.dims:
        arch.append("d" + ".".join(map(str, config.dims)))
    if config.channels:
        arch.append("c" + ".".join(map(str, config.channels)))
    if config.attention_backend != "auto":
        arch.append(f"attn={config.attention_backend}")
    if mode == "train" and config.remat:
        arch.append(f"remat{config.remat}")
    return "|".join([
        _device_kind(device), config.model_name, mode,
        "x".join(map(str, shape)), dtype, f"nc{config.num_classes}",
        config.optimizer if mode == "train" else "-",
    ] + arch)


def measure_candidate(config, benchmark: bool, mode: str,
                      shape: Tuple[int, ...], device="cuda", steps: int = 1,
                      warmup: int = 2) -> float:
    """Samples/s of the bench's ``Workload`` for ``config`` at ``shape``
    with ``cudnn.benchmark`` = ``benchmark`` (restored after): ``warmup``
    steps (cuDNN's search runs in the first), then ``bench.measure``'s
    windows (``steps`` doubled to 0.3 s, best of 2)."""
    from picklebot_tpu_torch.bench import Workload, measure
    from picklebot_tpu_torch.utils.config import replicated_equivalent

    device = torch.device(device)
    cfg = replicated_equivalent(dataclasses.replace(
        config, autotune=False, data_parallel=1))
    remat = int(cfg.remat) if mode == "train" else 0
    with cudnn_benchmark(benchmark):
        try:
            work = Workload(cfg, mode, shape, device, remat=remat)
            return measure(work, steps, warmup)[0]
        finally:
            work = None
            if device.type == "cuda":
                torch.cuda.empty_cache()


def autotune(config, mode: str = "train", device="cuda", steps: int = 1,
             warmup: int = 2, cache_path: Optional[str] = None,
             verbose: bool = False) -> bool:
    """The winning ``cudnn.benchmark`` for the config's workload on
    ``device``, measured (or from the cache). A single candidate
    short-circuits. A failed candidate is recorded and skipped; a cache
    entry with failures is re-measured for those only at the next call;
    if every candidate fails, RuntimeError."""
    cands = candidates()
    if len(cands) == 1:
        return cands[0]
    shape = _tune_shape(config, mode)
    path = cache_path or _cache_path()
    key = _cache_key(config, mode, shape, device)
    hit = _load_cache(path).get(key)
    if hit is not None and not hit.get("failed"):
        return hit["benchmark"]

    # failures may have been transient (an OOM beside another process):
    # keep the measurements, retry only the failed candidates
    measured = dict(hit["measured"]) if hit else {}
    retry_only = set(hit["failed"]) if hit else None
    failed = {}
    best, best_rate = None, -1.0
    for benchmark in cands:
        name = candidate_name(benchmark)
        if retry_only is not None and name not in retry_only \
                and name in measured:
            rate = measured[name]
        else:
            try:
                rate = measure_candidate(config, benchmark, mode, shape,
                                         device=device, steps=steps,
                                         warmup=warmup)
            except Exception as e:  # noqa: BLE001 -- recorded, skipped
                failed[name] = f"{type(e).__name__}: {e}"[:300]
                if verbose:
                    print(f"  {name:>14}: FAILED ({type(e).__name__})")
                continue
            measured[name] = rate
            if verbose:
                print(f"  {name:>14}: {rate:10.2f} samples/s "
                      f"({1e3 * shape[0] / rate:.3f} ms/step)")
        if rate > best_rate:
            best, best_rate = benchmark, rate
    if best is None:
        raise RuntimeError(
            f"autotune: every candidate failed for {key}: {failed}")
    cache = _load_cache(path)   # re-read: another process may have added
    cache[key] = {"benchmark": best, "samples_per_s": best_rate,
                  "measured": measured,
                  "ms_per_step": {n: 1e3 * shape[0] / r
                                  for n, r in measured.items()},
                  "unix_time": int(time.time()),
                  **({"failed": failed} if failed else {})}
    _save_cache(path, cache)
    return best


def autotune_config(config, mode: str = "train", device="cuda", **kw):
    """``train()``'s entry: (config with ``autotune`` off, the
    ``cudnn.benchmark`` value to apply, or None to leave the flag).
    ``varying_input_size`` skips the search and leaves the flag, as the
    reference leaves cudnn.benchmark off for it."""
    from picklebot_tpu_torch.parallel import mesh
    tuned = dataclasses.replace(config, autotune=False)
    if config.varying_input_size:
        return tuned, None
    if mesh.world() == 1:
        return tuned, autotune(config, mode, device=device, **kw)
    cands, idx, err = candidates(), -1, None
    if mesh.is_main():
        try:
            idx = cands.index(autotune(config, mode, device=device, **kw))
        except Exception as e:  # noqa: BLE001 -- raised after the broadcast
            err = e
    idx = mesh.broadcast_int(idx)
    if idx < 0:
        if err is not None:
            raise err
        raise RuntimeError("autotune failed on rank 0 (see its log); "
                           f"aborting on rank {mesh.rank()}")
    return tuned, cands[idx]


def main(argv=None):
    import argparse

    from picklebot_tpu_torch.utils.config import load_config
    from picklebot_tpu_torch.utils.devices import resolve_device

    p = argparse.ArgumentParser(
        description="Measure cudnn.benchmark off and on for a config's "
                    "workload on the device and cache the winner")
    p.add_argument("config", help="path to a config .json")
    p.add_argument("--mode", default="train", choices=["train", "infer"])
    p.add_argument("--batch", type=int, default=None,
                   help="override config batch_size")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--size", type=int, default=None)
    p.add_argument("--steps", type=int, default=1,
                   help="steps of the first timed window (doubled until "
                   "a window lasts 0.3 s)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    cfg = load_config(args.config)
    if args.batch:
        cfg = dataclasses.replace(cfg, batch_size=args.batch,
                                  effective_batch_size=args.batch)
    t, h, w = cfg.autotune_shape or cfg.synthetic_shape
    cfg = dataclasses.replace(cfg, autotune_shape=(
        args.frames or t, args.size or h, args.size or w))
    print(f"autotuning {cfg.model_name} {args.mode} at "
          f"{_tune_shape(cfg, args.mode)} on {_device_kind(device)} "
          f"({len(candidates())} candidates: cudnn.benchmark off, on)")
    winner = autotune(cfg, args.mode, device=device, steps=args.steps,
                      verbose=True)
    print(f"winner: cudnn.benchmark={winner}  (cached in {_cache_path()})")
    return winner


if __name__ == "__main__":
    main()
