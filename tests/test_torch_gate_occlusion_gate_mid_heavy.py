"""The gates of `tests/test_occlusion_gate.py`'s mid (47%) and heavy (63%)
levels: the port at seed 0 on the CPU, tracked from the true pose with the
reference's path draws injected, held to the reference test's assertions
(max tracked ADD-S under the level's limit, every coverage above the
re-init threshold). Their scenario checks and the other levels are in
`tests/test_torch_gate_occlusion_gate.py`; the split keeps each file within
its share of the tier-1 run.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE, TEST = "test_occlusion_gate.py", "test_tracking_under_occlusion"


@pytest.mark.parametrize("case", [p for p in P.gate_cases_of(FILE, TEST)
                                  if p.id in ("mid_47pct", "heavy_63pct")])
def test_tracking_under_occlusion(case):
    P.check_gate(case)
