"""``BENCHMARK.json`` against its contract, and every name in it resolved
to its file."""

import json
import re

import pytest

from portbench.harness import manifest

ROOT = manifest.ROOT
BENCH = manifest.load_manifest()
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert manifest.NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), (e["name"], key)
            if "unit" in e:
                assert manifest.UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert all(manifest.NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert manifest.NAME.match(w["config"])
        assert manifest.NAME.match(w["traffic"])
    assert len(names) == len(set(names))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_resolves():
    cells = {w["name"] for w in BENCH["workloads"]}
    used = set()
    for w in BENCH["workloads"]:
        cfg = manifest.load_config(BENCH, w["config"])
        entry = manifest.config_entry(BENCH, w["config"])
        assert entry["file"].startswith("portbench/")
        for key in entry["reduced"]:
            assert key in cfg["reduced"]
        used.add(w["config"])
        traffic = manifest.load_traffic(w["traffic"])
        assert callable(manifest.generator(traffic).run)
        assert manifest.load_limits(w["name"])
        e2e = manifest.metrics_of(BENCH, w["name"], trace=False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        per = manifest.metrics_of(BENCH, w["name"], trace=True)
        assert per
        moved = {m["name"] for m in e2e}
        for m in per:
            assert m["moves"] in moved, (w["name"], m["name"])
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_metric_has_its_reader():
    for m in BENCH["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))
    files = {p.name[:-3] for p in (manifest.BENCH_DIR / "metrics").glob(
        "*.py")}
    assert {m["name"] for m in BENCH["per_layer"]} <= files


def test_layers_spelled_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_chips_and_budget():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    # a full check of 24 cells fits its 43200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_paths_hold_files_named_from_names():
    for p in (manifest.BENCH_DIR).rglob("*"):
        rel = p.relative_to(ROOT).as_posix()
        if "__pycache__" in rel:
            continue
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", rel), rel


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_cut(cfg):
    c = manifest.load_config(BENCH, cfg)
    assert c["source"] == manifest.config_entry(BENCH, cfg)["source"]
    assert "precision" in c and "assumed" in c
    assert c["effective_batch_size"] % c["batch_size"] == 0
    json.dumps(c)
