"""Readings for the limits of ``correct``: many seeds of one cell in one
process, of the program as it is, of the control, or of the program
with a fault planted (``harness/faults.py``). One JSON line per seed.

    python3 portbench/tools/readings.py --workload NAME --seeds 1,2,3 \
        --seconds 2 [--mode program|control|f32|plain|half_batch|
        unchanged_state|answer_altered] [--init he|torch_default|...] \
        [--window-updates N]

``f32`` runs the program in float32 with TF32 off (its f32 policy),
``plain`` the program in its stated precision without its hand-written
kernels (each model's ``kernels=False``): with the program as it is,
they tell rounding from a fault. ``--init`` draws the weights by another
rule than the configuration's.

Not part of a benchmark run; it needs the card as a run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent.parent))

from portbench.harness import control, faults, manifest, program  # noqa
from portbench.harness import session  # noqa


@contextlib.contextmanager
def plain():
    """Every model the program builds runs without its kernels."""
    make = program.model

    def model(*args, **kwargs):
        m = make(*args, **kwargs)
        forward = m.forward
        m.forward = lambda x, *a, **k: forward(x, *a, kernels=False, **k)
        return m
    program.model = model
    try:
        yield
    finally:
        program.model = make


VARIANTS = {"plain": plain, **faults.FAULTS}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--mode", default="program",
                   choices=["program", "control", "f32", *VARIANTS])
    p.add_argument("--init", default=None)
    p.add_argument("--window-updates", type=int, default=0,
                   help="control: updates between the check steps and "
                        "the update after the window")
    args = p.parse_args(argv)
    bench = manifest.load_manifest()
    w = manifest.workload(bench, args.workload)
    cfg = manifest.load_config(bench, w["config"])
    if args.init:
        cfg["init"] = args.init
    if args.mode == "f32":
        cfg["use_autocast"] = False
    traffic = manifest.load_traffic(w["traffic"])
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        if args.mode == "control":
            numbers, notes = control.run(traffic["generator"], cfg,
                                         traffic, seed, "cuda",
                                         args.window_updates)
            line = {"numbers": numbers, "notes": notes}
        else:
            spec = session.Spec(
                w, cfg, traffic, manifest.load_limits(w["name"]),
                manifest.metrics_of(bench, w["name"], True),
                manifest.metrics_of(bench, w["name"], False), seed=seed,
                seconds=args.seconds, trace=False, t0=time.time())
            gen = manifest.generator(traffic)
            if args.mode in ("program", "f32"):
                out = gen.run(spec)
            else:
                with VARIANTS[args.mode]():
                    out = gen.run(spec)
            notes = out.get(session.NOTES, {})
            line = {"numbers": {**{k: v["value"]
                                   for k, v in out["checks"].items()},
                                **notes.get("not_compared", {})},
                    "correct": out["correct"], "metrics": out["metrics"],
                    "notes": notes}
        line.update(workload=args.workload, mode=args.mode, seed=seed,
                    init=cfg["init"], seconds=time.time() - t)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
