"""Library identification on the CPU: `LibrarySweep(shared_scene=True)`
over three distinct candidates (box, cylinder, sphere) on 160 x 120 frames
of the box, through the benchmark's identify loop (portbench/loops/
identify.py), held against the plain reference (portbench/reference/
identify.py, which imports nothing of the program):

- every program call of a recorded step is bitwise its eager replay, and
  candidate 0 is bitwise the per-scene path's fed copies of the frame;
- each candidate's identification score matches the reference's at the
  pose the step served, on the frame as the program prepared it, within
  SCORE_TOL;
- `named` is the reference's pick, by the reference's own rule over its own
  scores from the first step on, wherever the reference's lead lies
  further from the rule's than the scores' summed tolerance, and the
  program's summed scores are the reference's within it;
- the naming rule itself (`identify`, `_finish`): the scores summed over
  the state's steps, not restarted by a re-registration, none named (-1)
  until one candidate leads every other by more than IDENTIFY_LEAD, None
  for a per-scene sweep; on the scores of the first 96 steps of 16 seeds
  at VGA, recorded on the card (tests/data/identify_startup.json), no step
  names a wrong candidate and every seed names the box from step NAMED_BY
  on; and the tracer's `sweep.identify` span and `identify.*` counters.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep
from icra20_hand_object_pose_tpu_torch.parallel.sharding import IDENTIFY_LEAD, identify
from icra20_hand_object_pose_tpu_torch.utils import profiling
from portbench import generator, identify_check, loops
from portbench.reference import identify as ref
from portbench.spans import Spans
from portbench.tiny import tiny_cell

CELL = "identify.t42_identify8_vga"
SEED = 2**31 + 2203
STEPS = 3
# The reference poses the samples by explicit sums, the program by its own
# posing (se3, fused multiply-adds): the two may part in the last bits, so
# a sample whose projection lies within float rounding of a pixel's edge
# can read another pixel or another bilinear cell (the projective term
# then moves by up to ~(1 + 2) / 100 counted samples at this size), and a
# scene point within rounding of `scene_cov_tau` can turn (0.5 / ~200
# points). Otherwise the scores agree to float rounding (PERF.md section 6
# gives the largest difference seen on the CPU and on the card).
SCORE_TOL = 1e-4
# the identify cell's identification scores of its first 96 steps, recorded
# on the card from each state's first step (16 seeds, 8 candidates, the
# held box candidate 0; PERF.md section 6), and the step from which every
# step has to name the box (the last that named none was step 70)
STARTUP = Path(__file__).with_name("data") / "identify_startup.json"
NAMED_BY = 80


@pytest.fixture(scope="module")
def identified():
    """Three steps of the cut identify cell (three candidates) recorded and
    re-scored; the loop kept for the per-scene comparison."""
    torch.set_num_threads(2)
    spec, config, mix = tiny_cell(CELL)
    config = copy.deepcopy(config)
    config["library"] = ["box", "cylinder", "sphere"]
    est = config["estimator"]
    est["scene_points"], config["model_points"], est["model_points"] = 256, 128, 128
    config["render_points"] = 256
    est["pso"].update(particles=16, iters=2, polish_top_k=4, slide_proposals=2)
    est["tracker"].update(reinit_particles=32, reinit_prescreen=128,
                          prescreen_support=32)
    mix["frames"], mix["setup_frames"] = STEPS, 0
    traffic = generator.make(config, mix, SEED, "cpu")
    loop = loops.load("identify").Loop(config, traffic, SEED, "cpu", Spans())
    rec = identify_check.Recorder(loop)
    rec.on = True
    served = [loop.serve(i) for i in range(STEPS)]
    steps = identify_check.judge([identify_check.rescore(loop.sweep, s) for s in rec.steps],
                                 SCORE_TOL)
    return dict(loop=loop, rec=rec, served=served, steps=steps)


def test_programs_replay_bitwise(identified):
    for step in identified["steps"]:
        assert step["parting"] and not any(step["parting"]), step["parting"]


def test_candidate0_bitwise_per_scene(identified):
    """Object 0 of every recorded shared-scene call is bitwise object 0 of
    the per-scene sweep's call on copies of the frame with the same seeds."""
    sweep = identified["loop"].sweep
    per = LibrarySweep(sweep.objects, sweep._est.hand, sweep.cfg)
    step = identified["rec"].steps[1]            # a tracked step
    for call in step["calls"]:
        O = len(call["keys"])
        out = per._run(call["keys"], np.stack([call["depths"]] * O), call["prev"],
                       np.stack([call["hand_bases"]] * O),
                       np.stack([call["hand_qs"]] * O), call["mode"])
        for name, a, b in zip(out._fields, out, call["out"]):
            if a is not None:
                assert torch.equal(a[0], b[0]), name


def test_score_matches_reference(identified):
    for step in identified["steps"]:
        d = np.abs(np.asarray(step["port"]) - np.asarray(step["reference"]))
        assert (d <= SCORE_TOL).all(), (step["port"], step["reference"])


def test_named_is_the_reference_pick(identified):
    steps = identified["steps"]
    assert all(s["judged"] for s in steps), [s["lead"] for s in steps]
    for t, step in enumerate(steps):
        assert step["named"] == step["reference_named"], step
        d = np.abs(np.asarray(step["sums"]) - np.asarray(step["reference_sums"]))
        assert (d <= (t + 1) * SCORE_TOL).all(), (step["sums"], step["reference_sums"])


def test_served_pose_is_the_named_candidates(identified):
    """The loop serves the named candidate's pose where it names the held
    box, else (another candidate, or none yet) a non-finite pose."""
    for served, step in zip(identified["served"], identified["rec"].steps):
        res = step["result"]
        if int(res.named) == 0:
            assert np.array_equal(served.poses[0], res.poses[0].numpy())
        else:
            assert not np.isfinite(served.poses).any()
        assert torch.equal(served.fitness[0], res.fitness[max(int(res.named), 0)])


def _finish(sweep, state, scores, need_init):
    O = len(scores)
    pose = torch.eye(4).repeat(O, 1, 1)
    return sweep._finish(state, 1, torch.tensor(need_init), pose, torch.ones(O),
                         torch.ones(O), None, None,
                         torch.tensor(scores) if sweep.shared_scene else None)


def test_identify_names_by_the_lead():
    L = IDENTIFY_LEAD
    for sums, want in (([0.0, 2 * L, L], -1),             # leads by L: not more
                       ([0.0, 2 * L, L - 1e-9], 1),
                       ([3.0, 1.0, 3.0], -1),             # a tie names none
                       ([2 * L + 1.0, 0.0, 0.0], 0),
                       ([-5.0], 0)):                      # one candidate
        got = identify(torch.tensor(sums, dtype=torch.float64))
        assert got.dtype == torch.int64 and got.dim() == 0
        assert int(got) == want, sums


def test_startup_names_no_wrong_candidate():
    """From the first step of each recorded seed the rule (`_finish`'s sum,
    then `identify`) names none or the box, and the box on every step from
    NAMED_BY on; the reference's rule names alike."""
    data = json.loads(STARTUP.read_text())
    assert data["held"] == 0 and len(data["scores"]) == 16
    for seed, steps in data["scores"].items():
        assert len(steps) > NAMED_BY, seed
        total, sums, named, ref_named = None, None, [], []
        for scores in steps:
            x = torch.tensor(scores, dtype=torch.float32)
            total = x.double() + (total if total is not None else 0.0)
            named.append(int(identify(total)))
            n, sums = ref.name(x.tolist(), sums)
            ref_named.append(n)
        assert set(named) <= {-1, 0}, (seed, named)
        assert set(named[NAMED_BY:]) == {0}, (seed, named)
        assert ref_named == named, seed


def test_naming_rule(identified):
    sweep = identified["loop"].sweep            # shared scene, 3 candidates
    L = IDENTIFY_LEAD
    st = sweep.init_state()
    assert st.score_sum.tolist() == [0.0, 0.0, 0.0]
    st, res = _finish(sweep, st, [1.0, 1.0 + L / 2, 0.5], [True, True, True])
    assert int(res.named) == -1 and res.named.dtype == torch.int64
    assert st.score_sum.tolist() == [1.0, 1.0 + L / 2, 0.5]
    # candidate 1 re-registers and scores lowest: its sum keeps the steps
    # before, and it leads by more than L from here
    st, res = _finish(sweep, st, [1.0, 1.0 + L, 0.0], [False, True, False])
    assert st.score_sum.tolist() == [2.0, 2.0 + 1.5 * L, 0.5]
    assert int(res.named) == 1
    st, res = _finish(sweep, st, [1.0 + 1.5 * L, 1.0, 0.0], [False, False, False])
    assert int(res.named) == -1                  # a tie
    st, res = _finish(sweep, st, [1.0 + L, 0.0, 0.0], [False, False, False])
    assert int(res.named) == 0
    per = LibrarySweep(sweep.objects, sweep._est.hand, sweep.cfg)
    pst = per.init_state()
    assert pst.score_sum is None
    pst, res = _finish(per, pst, [1.0, 2.0, 2.0], [True, True, True])
    assert res.named is None and res.score is None and pst.score_sum is None


def test_identify_span_and_counters(identified):
    sweep = identified["loop"].sweep
    was = profiling.tracing(True)
    try:
        profiling.reset()
        st = sweep.init_state()
        L = IDENTIFY_LEAD
        for i, scores in enumerate(([0.0, 2 * L, 0.0], [5 * L, 0.0, 0.0], [0.0, 0.0, 0.0],
                                    [0.0, 2.5 * L, 0.0])):
            with profiling.span("sweep.step", frame=True):
                st, _ = _finish(sweep, st, scores, [i == 0] * 3)
        snap = profiling.snapshot()
    finally:
        profiling.tracing(was)
        profiling.reset()
    # named 1, then 0 (sums 5 L against 2 L), 0, then none (5 L against 4.5 L)
    assert snap["counters"]["identify.steps"] == 4
    assert snap["counters"]["identify.changes"] == 2
    assert snap["spans"]["sweep.identify"]["count"] == 4
    assert snap["per_frame"]["identify_change_share"] == 50.0


def test_shared_state_saves_its_sums(identified, tmp_path):
    """save_state / load_state keep each candidate's summed scores, so a
    resumed library names as the uninterrupted one."""
    sweep = identified["loop"].sweep
    st, _ = _finish(sweep, sweep.init_state(seed=7), [1.0, 2.5, 0.5], [True] * 3)
    sweep.save_state(st, str(tmp_path / "lib"))
    back = sweep.load_state(str(tmp_path / "lib"))
    assert torch.equal(back.score_sum, st.score_sum)
    assert back.score_sum.dtype == torch.float64
