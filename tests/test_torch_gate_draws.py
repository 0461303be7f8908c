"""The reference's recorded draws (`torch_gate_cases.RecordedDraws`, read
from `tests/torch_gate_draws.json`) against the reference's own
(`port_gate_parity.JaxDraws`): for every gate case at seeds 0 and 1, each
case's scenario builder (no rendering, no estimator) makes the same calls
and gets bitwise the same arrays from both. `chip_smoke.py` phase 17 runs
the card on these recorded scenes, so card seed s is the reference's seed
s. A draw the recording does not hold raises; it never falls back."""
import numpy as np
import pytest
import torch

import port_gate_parity as P
import torch_gate_cases as G

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def recorded():
    return G.RecordedDraws()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", list(G.CASES))
def test_recorded_draws_equal_the_reference(recorded, case, seed):
    want = G.draw_calls(case, seed, P.JaxDraws())
    got = G.draw_calls(case, seed, recorded)
    assert [(c["method"], c["args"]) for c in got] == [(c["method"], c["args"]) for c in want]
    for a, b in zip(got, want):
        for x, y in zip(np.atleast_1d(np.asarray(a["out"])), np.atleast_1d(np.asarray(b["out"]))):
            assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(np.asarray(a["out"]), np.asarray(b["out"]))


def test_recorded_draws_cover_seeds_0_to_7_and_raise_beyond(recorded):
    assert recorded.seeds == list(range(8))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    assert len(recorded.path(97 + 7, pose, 4, 0.05, 0.004)) == 4
    with pytest.raises(LookupError, match="no recorded draw"):
        recorded.path(97 + 8, pose, 4, 0.05, 0.004)
    with pytest.raises(LookupError, match="no recorded draw"):
        recorded.rotation(0 + 8, 4, 0, 1)
    with pytest.raises(LookupError, match="another pose"):
        recorded.path(97, np.eye(4, dtype=np.float32), 4, 0.05, 0.004)
