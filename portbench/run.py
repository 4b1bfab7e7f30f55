"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix; the mix names its generator
(``portbench/generators``), which makes the weights and inputs from the
seed on the card, warms the cell's shapes, measures for ``--seconds``,
and checks what the timed path produced against the plain reference
(``portbench/reference``). With ``--trace 0`` the line carries the
cell's end-to-end metrics; with ``--trace 1`` the per-layer ones, read
from a profiled window after the measured one (``portbench/metrics``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``busy_s`` and
``window_s`` when traced), ``breakdown`` when traced, and last
``checks``, each compared number beside its limit; the same numbers end
standard error. Without a CUDA card, or with fewer cards than the cell
asks for, the run exits non-zero and prints no result. It also fails if
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "picklebot_tpu")


def _cache_dirs():
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "portbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    from portbench.harness.device import process_start
    t0 = process_start()
    args = parse_args(argv)
    _cache_dirs()
    from portbench.harness import device, manifest, session
    bench = manifest.load_manifest()
    work = manifest.workload(bench, args.workload)
    device.require_cards(work["chips"])
    traffic = manifest.load_traffic(work["traffic"])
    spec = session.Spec(
        workload=work, config=manifest.load_config(bench, work["config"]),
        traffic=traffic, limits=manifest.load_limits(work["name"]),
        per_layer=manifest.metrics_of(bench, work["name"], trace=True),
        end_to_end=manifest.metrics_of(bench, work["name"], trace=False),
        seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
        t0=t0)
    line = manifest.generator(traffic).run(spec)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the benchmark and the "
              "port must not import JAX or the JAX package", file=sys.stderr)
        return 3
    notes = line.pop(session.NOTES, None)
    if notes:
        print(f"notes {json.dumps(notes)}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
