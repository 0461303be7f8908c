"""The result line: its keys, `compared` last, each number beside its
limit on standard error, JSON without NaN; and no result without a card.
Runs a cell cut to CPU size (tiny.py) through the whole harness."""
import io
import json
import subprocess
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import pytest

from portbench import harness, metrics
from portbench.tiny import tiny_cell

ROOT = Path(__file__).resolve().parent


@pytest.fixture(scope="module")
def lines():
    out = {}
    for traced in (False, True):
        r = harness.run("track.t42_box_vga", 2**31 + 99, 2.0, traced,
                        t_start=time.perf_counter(), device="cpu",
                        cell=tiny_cell("track.t42_box_vga"))
        so, se = io.StringIO(), io.StringIO()
        with redirect_stdout(so), redirect_stderr(se):
            rc = harness.emit(r)
        out[traced] = (rc, so.getvalue(), se.getvalue())
    return out


def test_untraced_line(lines):
    rc, so, se = lines[False]
    assert rc == 0
    r = json.loads(so.strip().splitlines()[-1])
    assert list(r)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert list(r["metrics"]) == harness.load_cell("track.t42_box_vga")[0]["end_to_end"]
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    tail = se.strip().splitlines()[-len(r["compared"]):]
    for line, (name, c) in zip(tail, r["compared"].items()):
        assert line == f"compared {name} {c['value']!r} limit {c['limit']!r}"


def test_traced_line(lines):
    rc, so, _ = lines[True]
    r = json.loads(so.strip().splitlines()[-1])
    assert set(r["metrics"]) <= set(metrics.load_all())
    # the CPU has no device trace: only the host's readings are there
    assert {"step_host_ms", "issue_ms", "mfu"} <= set(r["metrics"])
    # nor the CUDA events, nor a wait for the card to settle
    assert not {"knn_roofline", "device_idle_share", "settle_s"} & set(r["metrics"])


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, str(ROOT / "run.py"), "--workload", "track.t42_box_vga",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT.parent, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_seed_gives_the_same_inputs():
    from portbench import generator

    spec, config, mix = tiny_cell("sweep.t42_library8_vga")
    a = generator.make(config, mix, 2**31 + 5, "cpu")
    b = generator.make(config, mix, 2**31 + 5, "cpu")
    c = generator.make(config, mix, 2**31 + 6, "cpu")
    assert (a.depth == b.depth).all() and (a.pose_gt == b.pose_gt).all()
    assert not (a.depth == c.depth).all()
    # every seed serves the same path, centred on the start point
    assert (a.pose_gt == c.pose_gt).all()
    centres = a.pose_gt[:, :, :3, 3]
    assert abs(centres.mean(axis=0) - [0.0, 0.0, 0.5]).max() < 1e-4
