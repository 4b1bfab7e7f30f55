"""The control on the card, at each cell's own size: the reference in
float8 in the program's place must come out not correct, on three
seeds. Run on the card: python -m pytest portbench/tests -m card."""

import pytest

from portbench.harness import checks, control, manifest

BENCH = manifest.load_manifest()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    w = manifest.workload(BENCH, cell)
    cfg = manifest.load_config(BENCH, w["config"])
    traffic = manifest.load_traffic(w["traffic"])
    for seed in SEEDS:
        numbers, _ = control.run(traffic["generator"], cfg, traffic, seed,
                                 card)
        ok, _ = checks.judged(numbers, manifest.load_limits(cell))
        assert not ok, (seed, numbers)
