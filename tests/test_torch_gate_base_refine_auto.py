"""The port against `tests/test_base_refine_auto.py`: for both calibration
regimes, the scenario check (each of the 4 init trials the reference test
builds, captured from the test itself, against the case module
with the reference's draws injected: depth to 1e-5 m on pixels valid in
both, validity differing on at most 0.5% of pixels, reported hand bases and
ground truths to 1e-6) and the gate (4 global inits through the public
init path with the default config, held to the reference's success count).
The gates are init-heavy (about 75 s an init frame on the CPU) and `slow`;
`chip_smoke.py` phase 17 runs them on the card over seeds.
"""
import pytest
import torch

import port_gate_parity as P

torch.set_num_threads(2)
FILE = "test_base_refine_auto.py"
REGIMES = ["test_default_config_calibrated_regime",
           "test_default_config_miscalibrated_regime"]


@pytest.mark.parametrize("test", REGIMES)
def test_default_config_regime_scenario(test):
    (case,) = [p.values[0] for p in P.cases_of(FILE, test)]
    P.check_scenario(case)


@pytest.mark.slow
def test_default_config_calibrated_regime():
    P.check_gate(f"{FILE}::{REGIMES[0]}")


@pytest.mark.slow
def test_default_config_miscalibrated_regime():
    P.check_gate(f"{FILE}::{REGIMES[1]}")
