"""A new cell, traffic mix and per-layer metric take only new files and
a new ``BENCHMARK.json`` entry: in a copy of the benchmark, add them,
and run the new cell (tiny, on the CPU) and read the new metric, with
no file that was there edited."""

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVE = """
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


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts}


def test_new_cell_mix_and_metric_are_only_new_files(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = digest(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
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
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run([sys.executable, "-c", DRIVE, str(tmp_path),
                          str(ROOT)], capture_output=True, text=True,
                         timeout=600, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["read"]["clips_in_window.serve"]["value"] == 4
    assert {"serve_clips_per_s", "request_p95_ms", "setup_s"} == set(
        line["metrics"])
    after = digest(tmp_path)
    changed = {k for k in before if after.get(k) != before[k]}
    assert changed == {"BENCHMARK.json"}       # an entry added, no file
