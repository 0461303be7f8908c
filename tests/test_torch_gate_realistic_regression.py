"""The port against `tests/test_realistic_regression.py`: for each case,
the scenario check (the inputs the reference test builds, captured from
the test itself, against the case module with the reference's
draws injected: depth to 1e-5 m on pixels valid in both, validity
differing on at most 0.5% of pixels, reported hand bases and ground truths
to 1e-6) and the gate (the port at seed 0 on the CPU, held to the reference
test's assertions; where the reference itself fails an assertion on some
of its seeds, its worst value over them, from
`tests/torch_gate_reference.json`). The init cases are `slow`
(`chip_smoke.py` phase 17 runs them on the card over seeds). The sensor
model's properties are deterministic: the port's `apply_sensor_model`
gives the JAX package's output bitwise on the test's inputs, and passes
the test's assertions. The gates of `test_realistic_tracking` are in
`tests/test_torch_gate_realistic_tracking.py`, so that each file stays
within its share of the tier-1 run.
"""
import numpy as np
import pytest
import torch

import port_gate_parity as P
import torch_gate_cases as G

torch.set_num_threads(2)
FILE = "test_realistic_regression.py"
EXCURSION = f"{FILE}::test_realistic_tracking_base_refine_removes_excursion"
SENSOR = f"{FILE}::test_sensor_model_properties"


@pytest.mark.parametrize("case", P.cases_of(FILE, "test_realistic_tracking"))
def test_realistic_tracking_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", P.cases_of(FILE, "test_realistic_init"))
def test_realistic_init_scenario(case):
    P.check_scenario(case)


@pytest.mark.parametrize("case", P.gate_cases_of(FILE, "test_realistic_init"))
def test_realistic_init(case):
    P.check_gate(case)


def test_realistic_tracking_base_refine_removes_excursion_scenario():
    P.check_scenario(EXCURSION)


def test_realistic_tracking_base_refine_removes_excursion():
    P.check_gate(EXCURSION)


def test_sensor_model_properties_scenario():
    from icra20_hand_object_pose_tpu.datasets import (
        SensorModel as JaxSensorModel, apply_sensor_model as jax_apply,
    )
    from icra20_hand_object_pose_tpu_torch.datasets import (
        SensorModel, apply_sensor_model,
    )

    d = np.full((64, 64), 0.5, np.float32)
    d[:, 32:] = 1.0
    for seed, kw in enumerate([
            dict(noise_sigma=0.0, quantize=0.001, edge_sigma_px=0.0, dropout=0.0),
            dict(noise_sigma=0.002, quantize=0.0, edge_sigma_px=0.0, dropout=0.0),
            dict(noise_sigma=0.0, quantize=0.0, edge_sigma_px=0.7, dropout=0.0),
            {}]):
        out = apply_sensor_model(d, SensorModel(**kw), np.random.default_rng(seed))
        ref = jax_apply(d, JaxSensorModel(**kw), np.random.default_rng(seed))
        np.testing.assert_array_equal(out, ref)
    assert G.CASES[SENSOR].fn is G.sensor_model_properties


def test_sensor_model_properties():
    r = P.check_gate(SENSOR)
    assert r.passed, r.message()
