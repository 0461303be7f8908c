"""The port against `tests/test_score_concave.py::test_tracking_concave_mug`
(the file's first two tests are `tests/test_torch_score_concave.py`): the
scenario check (the reference test's 3-frame mug sequence, captured from
the test itself, against the port's `generate_sequence` through the case
module: depth to 1e-5 m on pixels valid in both, validity differing on at
most 0.5% of pixels, hand bases and ground truths to 1e-6, its
configuration) and the gate (a cold start on the mug, the last frame under
the reference's 10 mm; where the reference itself fails on some of its
seeds, its worst value over them, from `tests/torch_gate_reference.json`).
"""
import torch

import port_gate_parity as P

torch.set_num_threads(2)
CASE = "test_score_concave.py::test_tracking_concave_mug"


def test_tracking_concave_mug_scenario():
    P.check_scenario(CASE)


def test_tracking_concave_mug():
    P.check_gate(CASE)
