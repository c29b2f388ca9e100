"""The correctness control, the precision one step below the
configuration's (``controls.py``), comes out not correct in every cell at a
size a test run holds; ``control.py`` runs it on the card at the cells'
own sizes."""

import pytest
from conftest import CELLS, SEED, dry_run

from perfbench import harness


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_the_control_is_not_correct(workload):
    _, _, config, traffic = harness.cell_data(workload, CELLS[workload])
    control = harness.load_module("kinds", traffic["kind"]).CONTROL
    for seed in (SEED, SEED + 1, SEED + 2):
        with control(config):
            r = dry_run(workload, seed)
        assert r["correct"] is False
        assert all(c["value"] > c["limit"] for c in r["compared"].values())
