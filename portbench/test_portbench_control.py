"""The lower-precision control on the card at each cell's own size: the
reference put in the program's place in bfloat16 must read `correct`
false on three seeds, by its rigid check. Needs a CUDA device (about 5
minutes there)."""
import time

import pytest

from portbench import faults, harness

CELLS = ["track.t42_box_vga", "sweep.t42_library8_vga", "regrasp.t42_box_vga"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for seed in (2**31 + 71, 2**31 + 72, 2**31 + 73):
        control = harness.run(cell, seed, 5.0, False, t_start=time.perf_counter(),
                              fault=faults.control_bf16)
        assert control["correct"] is False, control["compared"]
        assert control["compared"]["rigid_err"]["value"] > \
            control["compared"]["rigid_err"]["limit"]
