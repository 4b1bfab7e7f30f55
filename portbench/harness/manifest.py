"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix. Each is found by its name alone:

* ``portbench/configs/<config>.json``: the model configuration as run;
* ``portbench/traffic/<traffic>.json``: the mix's parameters, with
  ``generator``, the module of ``portbench/generators`` that runs it;
* ``portbench/limits/<workload>.json``: the limits of the numbers that
  decide ``correct`` in that cell;
* ``portbench/metrics/<metric>.py``: the reader of a per-layer metric;
* ``portbench/reference/<name>.py``: the plain reference of a
  configuration whose file carries ``"reference": "<name>"``.

So a new cell, mix, metric or configuration is new files and a new
entry, and no edit. A configuration's reference keeps three contracts:

1. **Found by its file** (``harness/references.py``). The module's
   ``build(cfg)`` returns the float32 model in plain ``torch``, importing
   nothing of the port and nothing of JAX; its ``forward(x,
   generator=None)`` takes (B, 3, T, H, W). It may define
   ``loss_terms(model)``, what the configuration's program step adds to
   the cross entropy before the backward (the MoE auxiliary loss times
   ``moe_aux_weight``): the reference's steps add it there, and the
   logged loss stays the cross entropy, as the program logs it. A
   configuration without the key is built by ``reference/models.py``
   ``build`` from its ``model_name``.
2. **Weights drawn by module kind** (``harness/weights.py``). Each leaf
   of the state takes its rule from the module that owns it: a weight of
   2 or more dims the configuration's ``init``; the ``weight`` of a
   normalization module 1 + 0.1 N and its ``bias`` 0.1 N, where a
   normalization module is a BatchNorm or InstanceNorm, ``LayerNorm``,
   ``GroupNorm``, ``RMSNorm``, or any module whose class sets
   ``is_normalization = True`` (an RMSNorm written in a reference file);
   BatchNorm running variances exp(0.2 N); every other float leaf
   0.1 N; integer buffers 0.
3. **Kernel calls reported by the modules** (``harness/work.py``
   ``geometry``). A module that stands for one of the program's
   hand-written functions defines ``kernel_call(args) -> (family,
   geometry)``, or None where this call takes no such function; ``args``
   are its forward's positional arguments. Families are open: a new
   kernel is a new key, and a family with no call reads ``[]``.
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
