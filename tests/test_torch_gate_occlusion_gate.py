"""The port against `tests/test_occlusion_gate.py`: for each occlusion
level, the scenario check (the inputs the reference test builds, captured
from the test itself, against the case module with the reference's
draws injected: depth to 1e-5 m on pixels valid in both, validity differing
on at most 0.5% of pixels, hand bases and ground truths to 1e-6) and the
gate (the port at seed 0 on the CPU, held to the reference test's
assertions: max tracked ADD-S under the level's limit, every coverage above
the re-init threshold; where the reference itself fails an assertion on
some of its seeds, its worst value over them, from
`tests/torch_gate_reference.json`). `realistic_heavy` starts with a global
init and is `slow`; `chip_smoke.py` phase 17 runs it on the card. The
gates of the mid and heavy levels are in
`tests/test_torch_gate_occlusion_gate_mid_heavy.py`, so that each file
stays within its share of the tier-1 run.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE, TEST = "test_occlusion_gate.py", "test_tracking_under_occlusion"


@pytest.mark.parametrize("case", P.cases_of(FILE, TEST))
def test_tracking_under_occlusion_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", [p for p in P.gate_cases_of(FILE, TEST)
                                  if p.id in ("low_18pct", "realistic_heavy")])
def test_tracking_under_occlusion(case):
    P.check_gate(case)
