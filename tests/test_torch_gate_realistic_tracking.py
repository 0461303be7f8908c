"""The gates of `tests/test_realistic_regression.py::test_realistic_tracking`
(ellipsoid and asym, 3 frames under the realistic sensor with the
hand-mount error, tracked from the first ground truth): the port at seed 0
on the CPU, held to the reference test's assertions (the last frame's
ADD-S under the shape's limit, no coverage watchdog misfire); where the
reference itself fails an assertion on some of its seeds, its worst value
over them, from `tests/torch_gate_reference.json`. Their scenario checks
and the file's other cases are in
`tests/test_torch_gate_realistic_regression.py`; the split keeps each file
within its share of the tier-1 run.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE = "test_realistic_regression.py"


@pytest.mark.parametrize("case", P.gate_cases_of(FILE, "test_realistic_tracking"))
def test_realistic_tracking(case):
    P.check_gate(case)
