"""The port against `tests/test_accuracy_regression.py`: for each pinned
case, the scenario check (the reference test's 4-frame sequence, captured
from the test itself, against the port's `generate_sequence` through the
case module: depth to 1e-5 m on pixels valid in both, validity differing
on at most 0.5% of pixels, hand bases and ground truths to 1e-6) and the
gate (the port at seed 0 on the CPU, tracked from the first ground truth,
held to the reference's pinned mean ADD-S and its 8 mm worst frame; where
the reference itself fails an assertion on some of its seeds, its worst
value over them, from `tests/torch_gate_reference.json`). The two noisy cases' gates are in
`tests/test_torch_gate_accuracy_regression_noisy.py`, so that each file
stays within its share of the tier-1 run.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE, TEST = "test_accuracy_regression.py", "test_tracked_adds_pinned"


@pytest.mark.parametrize("case", P.cases_of(FILE, TEST))
def test_tracked_adds_pinned_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", [p for p in P.gate_cases_of(FILE, TEST)
                                  if p.id == "asym-False"])
def test_tracked_adds_pinned(case):
    P.check_gate(case)
