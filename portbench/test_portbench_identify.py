"""The identify cell, cut to CPU size (tiny.py, and a library of three of
its candidates), through the whole harness to its result line: a sound run
reads `correct` true; a step that names another candidate than the held
box serves a non-finite pose and turns `correct` false, as `stale` does;
and under `lag` each step serves the pose the step before served. The
metric `search_pairs_m` reads the kernels' launch counters over every
step an identify loop served, and nothing where none did. About four
minutes on the CPU."""
import io
import json
import time
from collections import Counter
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest

from portbench import faults, generator, harness, loops, metrics
from portbench.spans import Spans
from portbench.tiny import tiny_cell

CELL = "identify.t42_identify8_vga"
SEED = 2**31 + 4321


def _cut():
    spec, config, mix = tiny_cell(CELL)
    config["library"] = ["box", "sphere", "ellipsoid"]
    return spec, config, mix


def wrong_pick(loop) -> None:
    """Every step names the candidate after the one the program named."""
    real = loop.entry

    def entry(sweep, state, *frame):
        new, res = real(sweep, state, *frame)
        return new, res._replace(named=(res.named + 1) % sweep.n_objects)

    loop.entry = entry


def _run(fault=None, traced=False):
    return harness.run(CELL, SEED, 2.0, traced, t_start=time.perf_counter(),
                       device="cpu", cell=_cut(), fault=fault)


def test_sound_run_line():
    r = _run()
    so, se = io.StringIO(), io.StringIO()
    with redirect_stdout(so), redirect_stderr(se):
        assert harness.emit(r) == 0
    line = json.loads(so.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0, line["compared"]
    assert list(line["metrics"]) == ["setup_s", "frame_ms", "frame_ms_p95"]
    assert list(line)[-1] == "compared"


@pytest.mark.parametrize("fault", [wrong_pick, faults.stale], ids=["wrong_pick", "stale"])
def test_fault_turns_correct_false(fault):
    r = _run(fault)
    assert r["correct"] is False, r["compared"]
    if fault is wrong_pick:
        assert r["failed"] == r["attempted"] > 0


def test_lag_serves_the_step_before():
    spec, config, mix = _cut()
    traffic = generator.make(config, mix, SEED, "cpu")
    served = {}
    for name in (None, "lag"):
        loop = loops.load(traffic.loop).Loop(config, traffic, SEED, "cpu", Spans())
        if name:
            faults.FAULTS[name](loop)
        served[name] = np.stack([loop.serve(i).poses for i in range(3)])
    assert (served["lag"][1:] == served[None][:-1]).all()
    assert not (served["lag"][1:] == served[None][1:]).all()


def test_search_pairs_reads_every_served_step(monkeypatch):
    from portbench import port
    from portbench.loops import identify

    read = metrics.load_all()["search_pairs_m"].read
    none = (0, Counter())
    before = {"nn_gather_batched": (1, Counter({(8, 1, 512, 256): 1})),
              "nn_batched": none, "nn_gn_batched": none, "gn_iterate_batched": none}
    now = {"nn_gather_batched": (5, Counter({(8, 1, 512, 256): 3, (16, 1, 2048, 1024): 1})),
           "nn_batched": none, "nn_gn_batched": (1, Counter({(8, 8, 512, 256): 1})),
           "gn_iterate_batched": (7, Counter({(8, 8, 512): 7}))}
    monkeypatch.setattr(port, "launch_counts", lambda: now)
    monkeypatch.setitem(identify.SERVED, "launches", before)
    monkeypatch.setitem(identify.SERVED, "steps", 4)
    r = metrics.Readings(config=_cut()[1], frames=2, window_s=1.0, latency_s=[0.5] * 2,
                         spans={}, program_ms=[], settle_s=0.0, init_object_frames=0,
                         track_object_frames=2, trace={})
    pairs = 2 * 8 * 512 * 256 + 16 * 2048 * 1024 + 8 * 512 * 256
    assert read(r) == pytest.approx(1e-6 * pairs / 4)
    monkeypatch.setitem(identify.SERVED, "steps", 0)     # no identify loop served
    assert read(r) is None
