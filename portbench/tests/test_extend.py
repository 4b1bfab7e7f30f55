"""A new cell, traffic mix, per-layer metric or configuration takes only
new files and new ``BENCHMARK.json`` entries: in a copy of the
benchmark, add them, and run the new cell (tiny, on the CPU), with no
file that was there edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE_SERVE = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench.harness import manifest, session
from portbench.tests import tiny
assert manifest.BENCH_DIR.parent.as_posix() == sys.argv[1]
spec = tiny.spec("large3d_serve_b4", root=sys.argv[1])
out = manifest.generator(spec.traffic).run(spec)
win = session.Window("serve", [], [], (0.0, 1.0), clips=4, forwards=1,
                     backwards=0, steps=0, rate=out["metrics"][
                         "serve_clips_per_s"]["value"], flops_per_clip=0,
                     calls={}, host_ms=[1.0])
read = session.read_per_layer(win, spec.per_layer)
print(json.dumps({"correct": out["correct"], "metrics": out["metrics"],
                  "read": read}))
"""

DRIVE_CONFIG = """
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.append(sys.argv[2])
from portbench.harness import manifest, references
from portbench.tests import tiny
assert manifest.BENCH_DIR.parent.as_posix() == sys.argv[1]
spec = tiny.spec("large3d_by_file_train", root=sys.argv[1])
out = manifest.generator(spec.traffic).run(spec)
mod = references.module_of(spec.config)
print(json.dumps({"correct": out["correct"], "checks": out["checks"],
                  "metrics": sorted(out["metrics"]),
                  "file": mod.__file__, "built": mod.BUILT,
                  "terms": len(mod.TERMS)}))
"""

# a configuration's own reference: the model the port's registry builds
# as MobileNetLarge3D, made from the reference's classes, and a loss
# term that adds nothing, so that the run shows both are found by file
REFERENCE = '''"""MobileNetLarge3D from the plain reference's classes."""

from portbench.reference import models as R

BUILT, TERMS = [], []


def build(cfg):
    BUILT.append(cfg["model_name"])
    return R.MobileNetLarge3D(cfg["num_classes"])


def loss_terms(model):
    TERMS.append(1)
    return 0.0 * model.block1[0].weight.sum()
'''


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def copy_of_the_benchmark(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return digest(tmp_path), json.loads(
        (tmp_path / "BENCHMARK.json").read_text())


def drive(tmp_path, bench, before, script):
    """Write ``bench``, run ``script`` in the copy, check that only
    ``BENCHMARK.json`` of the files that were there changed, and return
    the script's last line."""
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    after = digest(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}       # entries added, no file
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_new_cell_mix_and_metric_are_only_new_files(tmp_path):
    before, bench = copy_of_the_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    traffic = json.loads((pb / "traffic" / "serve_closed_b8.json").read_text())
    traffic.update(batch=4, why="calls of 4 clips")
    (pb / "traffic" / "serve_closed_b4.json").write_text(json.dumps(traffic))
    (pb / "limits" / "large3d_serve_b4.json").write_text(
        (pb / "limits" / "large3d_serve_b8.json").read_text())
    (pb / "metrics" / "clips_in_window.serve.py").write_text(
        "def read(win):\n    return win.clips\n")
    bench["workloads"].append({"name": "large3d_serve_b4",
                               "config": "mobilenet_large3d",
                               "traffic": "serve_closed_b4", "chips": 1,
                               "why": "calls of 4 clips"})
    bench["end_to_end"] += [
        {"name": "serve_clips_per_s", "unit": "clips/s", "better": "higher",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["large3d_serve_b4"]},
        {"name": "request_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["large3d_serve_b4"]}]
    bench["per_layer"].append({
        "name": "clips_in_window.serve", "unit": "clips", "better": "higher",
        "source": "program_counter", "layer": "the device",
        "moves": "serve_clips_per_s", "workloads": ["large3d_serve_b4"]})
    line = drive(tmp_path, bench, before, DRIVE_SERVE)
    assert line["correct"]
    assert line["read"]["clips_in_window.serve"]["value"] == 4
    assert {"serve_clips_per_s", "request_p95_ms", "setup_s"} == set(
        line["metrics"])


def test_new_configuration_with_its_own_reference_is_only_new_files(
        tmp_path):
    """A configuration that names its own reference file runs as a
    training cell: the file builds the model (and its loss terms join
    the reference's steps), and nothing of the benchmark is edited."""
    before, bench = copy_of_the_benchmark(tmp_path)
    pb = tmp_path / "portbench"
    cfg = json.loads((pb / "configs" / "mobilenet_large3d.json").read_text())
    cfg["reference"] = "large3d_by_file"
    (pb / "configs" / "large3d_by_file.json").write_text(json.dumps(cfg))
    (pb / "reference" / "large3d_by_file.py").write_text(REFERENCE)
    (pb / "limits" / "large3d_by_file_train.json").write_text(
        (pb / "limits" / "large3d_train_b64x4.json").read_text())
    entry = dict(next(c for c in bench["configs"]
                      if c["name"] == "mobilenet_large3d"),
                 name="large3d_by_file",
                 file="portbench/configs/large3d_by_file.json",
                 why="MobileNetLarge3D through a reference file of its own")
    bench["configs"].append(entry)
    bench["workloads"].append({
        "name": "large3d_by_file_train", "config": "large3d_by_file",
        "traffic": "train_accum", "chips": 1,
        "why": "the training step of a configuration found by its file"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "large3d_train_b64x4" in m.get("workloads", []):
            m["workloads"].append("large3d_by_file_train")
    line = drive(tmp_path, bench, before, DRIVE_CONFIG)
    assert line["correct"], line["checks"]
    assert line["metrics"] == ["setup_s", "train_clips_per_s"]
    assert Path(line["file"]) == pb / "reference" / "large3d_by_file.py"
    # the weights, the reference's steps and the update after the window
    assert line["built"] and set(line["built"]) == {"MobileNetLarge3D"}
    assert line["terms"] > 0
