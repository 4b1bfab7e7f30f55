"""Tiny specs of the cells for CPU tests: the cell's configuration and
traffic at 16x32x32 clips, two clips a batch, float32 compute.

``KEPT`` are cells whose files the benchmark keeps but whose entry
``BENCHMARK.json`` leaves out for now (``PERF.md`` says why); their
generators are tested all the same."""

import time

from portbench.harness import manifest, session

KEPT = {"large3d_serve_b8": {"name": "large3d_serve_b8",
                             "config": "mobilenet_large3d",
                             "traffic": "serve_closed_b8", "chips": 1}}


def workload(bench, name):
    return KEPT[name] if name in KEPT else manifest.workload(bench, name)


def spec(workload_name, seed=7, seconds=0.3, root=None):
    bench = manifest.load_manifest(root) if root else manifest.load_manifest()
    w = workload(bench, workload_name)
    cfg = manifest.load_config(bench, w["config"])
    cfg.update(clip=[16, 32, 32], use_autocast=False)
    traffic = manifest.load_traffic(w["traffic"])
    if traffic["generator"] == "serve_closed":
        traffic.update(batch=2, pool=4, warm_calls=1)
    else:
        cfg.update(batch_size=2, effective_batch_size=4)
    return session.Spec(
        w, cfg, traffic, manifest.load_limits(w["name"]),
        manifest.metrics_of(bench, w["name"], True),
        manifest.metrics_of(bench, w["name"], False), seed=seed,
        seconds=seconds, trace=False, t0=time.time(), device="cpu")
