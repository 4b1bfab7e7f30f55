"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is found by its name alone:

* ``portbench/configs/<config>.json``: the model configuration as run;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, with
  ``generator``, the module of ``portbench/generators`` that runs it;
* ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
* ``portbench/metrics/<metric>.py``: the reader of a per-layer metric.

So a new cell, mix or metric is new files and a new entry, and no edit.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as fh:
        return json.load(fh)


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: "
                   f"{', '.join(w['name'] for w in manifest['workloads'])})")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    return _json(Path(root) / config_entry(manifest, name)["file"])


def load_traffic(name: str) -> dict:
    return _json(BENCH_DIR / "traffic" / f"{name}.json")


def load_limits(workload_name: str) -> dict:
    return _json(BENCH_DIR / "limits" / f"{workload_name}.json")


def generator(traffic: dict):
    return importlib.import_module(
        f"portbench.generators.{traffic['generator']}")


def metric_reader(name: str):
    """The ``read(ctx)`` of ``portbench/metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(manifest: dict, workload_name: str, trace: bool) -> list:
    """The entries of the metrics this cell reports: the end-to-end ones
    untraced, the per-layer ones traced; an entry with ``workloads``
    only in the cells it lists."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if "workloads" not in m or workload_name in m["workloads"]]
