"""As test_perfbench_faults.py, for the resize cells."""

import pytest
from conftest import dry_run

import faults

FAULTS = ("unchanged", "half", "altered")


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("workload", ["resize_bilinear4096.resident",
                                      "resize_bilinear4096.plainfract"])
def test_a_resize_fault_is_not_correct(workload, fault):
    with faults.resize(fault):
        r = dry_run(workload)
    assert r["correct"] is False and r["failed"] == 1
    assert r["compared"]["mismatched_coeffs"]["value"] > 0
