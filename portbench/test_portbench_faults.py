"""The comparison catches each fault a cell can have and the
lower-precision control: a cell cut to CPU size, run through the whole
harness (the look for a card skipped) with its entry broken underneath,
reads `correct` false; the same run unbroken reads true."""
import time

import pytest

from portbench import faults, harness
from portbench.tiny import tiny_cell

# A pose served a frame late is caught on the card at the cells' own size
# (PERF.md): in the cut tracked cells the coarse tracker's own error (~3 mm)
# hides a frame's motion, so there `test_lag_serves_the_frame_before` holds
# the fault itself.
CUT_HIDES = {("track.t42_box_vga", "lag"), ("sweep.t42_library8_vga", "lag")}
CASES = [(cell, name)
         for cell, loop in (("track.t42_box_vga", "track"),
                            ("sweep.t42_library8_vga", "sweep"),
                            ("regrasp.t42_box_vga", "regrasp"))
         for name in [None, *faults.applicable(loop), "control_bf16"]
         if (cell, name) not in CUT_HIDES]


@pytest.mark.parametrize("cell,name", CASES, ids=lambda x: str(x))
def test_fault_turns_correct_false(cell, name):
    fault = (faults.control_bf16 if name == "control_bf16"
             else faults.FAULTS[name] if name else None)
    r = harness.run(cell, 2**31 + 4321, 1.0, False, t_start=time.perf_counter(),
                    device="cpu", cell=tiny_cell(cell), fault=fault)
    assert r["correct"] is (name is None), r["compared"]


@pytest.mark.parametrize("cell", ["track.t42_box_vga", "sweep.t42_library8_vga"])
def test_lag_serves_the_frame_before(cell):
    """Under `lag` each frame serves what the sound entry served for the
    frame before, and the program's state advances as in a sound run."""
    import numpy as np

    from portbench import generator, loops
    from portbench.spans import Spans

    spec, config, mix = tiny_cell(cell)
    seed = 2**31 + 77
    traffic = generator.make(config, mix, seed, "cpu")
    served = {}
    for name in (None, "lag"):
        loop = loops.load(traffic.loop).Loop(config, traffic, seed, "cpu", Spans())
        if name:
            faults.FAULTS[name](loop)
        served[name] = np.stack([loop.serve(i).poses for i in range(4)])
    assert (served["lag"][1:] == served[None][:-1]).all()
    assert not (served["lag"][1:] == served[None][1:]).all()
