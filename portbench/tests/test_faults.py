"""Whole runs of each cell on the CPU at a tiny size (the look for a
card skipped), as they are and with the timed path broken underneath:
``correct`` comes out true, then false for every fault the cell can
have. The limits are the cells' own."""

import pytest

from portbench.harness import faults, manifest, session
from portbench.tests import tiny

BENCH = manifest.load_manifest()
CELLS = [w["name"] for w in BENCH["workloads"]] + sorted(tiny.KEPT)
FAULTS = {"serve_closed": ["answer_altered"],
          "train_accum": ["half_batch", "unchanged_state",
                          "unchanged_after_checks"]}
CASES = [(c, f) for c in CELLS for f in FAULTS[manifest.load_traffic(
    tiny.workload(BENCH, c)["traffic"])["generator"]]]


def run(spec):
    return manifest.generator(spec.traffic).run(spec)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out = run(tiny.spec(cell))
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert [k for k in out if k != session.NOTES][-1] == "checks"


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_seen(cell, fault):
    with faults.FAULTS[fault]():
        out = run(tiny.spec(cell))
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", [c for c, f in CASES
                                  if f == "unchanged_after_checks"])
def test_only_the_late_update_sees_a_late_fault(cell):
    """A fault that starts after the check steps passes every number of
    the check steps and fails the update after the window."""
    with faults.FAULTS["unchanged_after_checks"]():
        out = run(tiny.spec(cell))
    early = {k: v for k, v in out["checks"].items()
             if not k.startswith("late_")}
    assert all(v["value"] <= v["limit"] for v in early.values()), early
    assert out["checks"]["late_update_gap"]["value"] > \
        out["checks"]["late_update_gap"]["limit"]
