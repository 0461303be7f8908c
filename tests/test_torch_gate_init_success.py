"""The port against `tests/test_init_success.py`: for each case, the
scenario check (every init trial and recovery view the reference test
builds, captured from the test itself, against the case module
with the reference's draws injected: depth to 1e-5 m on pixels valid in
both, validity differing on at most 0.5% of pixels, hand bases and ground
truths to 1e-6, the test's keys) and the gate (the global inits, held to
the reference's success count; the slide cases' frame-0 ADD-S under 10% of
the diameter). The gates are init-heavy (about 75 s an init frame on the
CPU) and `slow`; `chip_smoke.py` phase 17 runs them on the card over seeds.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE = "test_init_success.py"


@pytest.mark.parametrize("case", P.cases_of(FILE, "test_global_init_success"))
def test_global_init_success_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", P.gate_cases_of(FILE, "test_global_init_success"))
def test_global_init_success(case):
    P.check_gate(case)


@pytest.mark.parametrize("case", P.cases_of(FILE, "test_grasp_occluded_slide_case"))
def test_grasp_occluded_slide_case_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", P.gate_cases_of(FILE, "test_grasp_occluded_slide_case"))
def test_grasp_occluded_slide_case(case):
    P.check_gate(case)
