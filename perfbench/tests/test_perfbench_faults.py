"""A run with the timed path broken underneath comes out not correct: for
each cell, each fault that it can have (one card: no exchange between
chips to leave out)."""

import pytest
from conftest import dry_run

import faults

FAULTS = ("unchanged", "half", "altered")


@pytest.mark.parametrize("fault", FAULTS)
def test_a_jpeg_fault_is_not_correct(fault):
    with faults.jpeg(fault):
        r = dry_run("jpeg4096.resident")
    assert r["correct"] is False and r["failed"] == 1
    assert r["compared"]["mismatched_residues"]["value"] > 0
