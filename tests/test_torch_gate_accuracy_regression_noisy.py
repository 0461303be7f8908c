"""The gates of `tests/test_accuracy_regression.py`'s two noisy cases
(asym and mug, 1 mm depth noise and 2% dropout): the port at seed 0 on the
CPU, tracked from the first ground truth, held to the reference's pinned
mean ADD-S and its 8 mm worst frame. Their scenario checks, and the clean
case, are in `tests/test_torch_gate_accuracy_regression.py`; the split
keeps each file within its share of the tier-1 run.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE, TEST = "test_accuracy_regression.py", "test_tracked_adds_pinned"


@pytest.mark.parametrize("case", [p for p in P.gate_cases_of(FILE, TEST)
                                  if p.id.endswith("-True")])
def test_tracked_adds_pinned(case):
    P.check_gate(case)
