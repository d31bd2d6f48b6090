"""A run with a fault planted under its timed path comes out not correct:
each fault that a cell can have, on the CPU at tiny sizes, the harness's
look for a card skipped."""

import pytest

from stereobench import faults
from stereobench.tests import tiny
from stereobench.tools import calibrate


CASES = [(w, f) for w in tiny.WORKLOADS
         for f in calibrate.applicable(tiny.cell(w))]


@pytest.mark.parametrize("workload,fault", CASES)
def test_a_fault_makes_the_run_not_correct(workload, fault):
    with faults.FAULTS[fault]():
        result = tiny.execute(workload, seed=2 ** 31 + 11)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("workload", tiny.WORKLOADS)
def test_the_same_run_without_a_fault_is_correct(workload):
    result = tiny.execute(workload, seed=2 ** 31 + 11)
    assert result["correct"] is True, result["checks"]
