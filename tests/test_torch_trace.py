"""The port's tracer (utils/profiling.py) on the CPU, at
`tests/test_torch_program.py`'s tiny size, where a program calls its
traced function directly and the stage marks read the host clock:

- off by default, and then it records nothing;
- an init frame then a tracked frame: each span under its parent with its
  frame, each of the five stages once a frame and in order, the counters;
- results bitwise equal with the tracer on and off (`Tracker.step` in both
  modes, `LibrarySweep.step` per scene);
- a mixed sweep step's counters (objects 1 and 5 re-initialise);
- the scorer's particles by tier (`score.points.*` in point mode,
  `score.renders.*` in pixel mode),
  and a capture's counts taken out and added once per replay;
- span self times, the innermost open span and the per-frame readings on
  a fake clock;
- the spans as `record_function` ranges under torch.profiler.

The case marked `cuda` (skipped without a card; this file imports no jax,
so `python -m pytest --noconftest -m cuda tests/test_torch_trace.py` runs
it on the card) captures a program with the tracer off and on: the same
kernel nodes, event-record nodes only with it on, the same results, and
the five stages summing to the CUDA events around a replay.
"""
import dataclasses

import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep
from icra20_hand_object_pose_tpu_torch.utils import meshio, profiling
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, ScoreConfig, TrackerConfig,
)

torch.set_num_threads(2)


def _setup(device, n_objects=2, particles=16, iters=3):
    """`test_torch_program.py`'s tiny size: 64 x 48, 256 scene points, 16
    particles x 3 iterations, a 64-orientation prescreen; box and cylinder
    in turn, one frame each."""
    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    cfg = EstimatorConfig(
        camera=cam, scene_points=256, render_size=48,
        pso=PsoConfig(particles=particles, iters=iters, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=particles, reinit_prescreen=64),
    )
    hand = make_t42_hand(points_per_link=64, device=device)
    meshes = [meshio.make_test_object(s) for s in ("box", "cylinder")]
    objs = [ObjectModel(meshes[i % 2], model_points=256, render_points=512, seed=i,
                        device=device) for i in range(n_objects)]
    frames = [generate_sequence(m, hand, SyntheticSequenceConfig(
        n_frames=1, camera=cam, noise_sigma=0.0), device=device)[0] for m in meshes]
    return dict(cfg=cfg, hand=hand, objs=objs, frames=frames)


@pytest.fixture(scope="module")
def tiny():
    return _setup("cpu")


class _Traced:
    """The tracer on and reset inside, off after."""

    def __init__(self, on: bool = True):
        self.on = on

    def __enter__(self):
        self.was = profiling.tracing(self.on)
        profiling.reset()
        return profiling.TRACER

    def __exit__(self, *exc):
        profiling.tracing(self.was)
        profiling.reset()
        return False


def _track_two(tiny, on: bool):
    """A fresh Tracker's init frame then a tracked frame; the results and
    the tracer's snapshot."""
    fr = tiny["frames"][0]
    with _Traced(on):
        tracker = Tracker(Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"]), seed=3)
        res = [tracker.step(fr.depth, fr.hand_base, fr.hand_q) for _ in range(2)]
        return res, profiling.snapshot()


@pytest.fixture(scope="module")
def tracked(tiny):
    return {on: _track_two(tiny, on) for on in (False, True)}


def test_off_by_default_records_nothing(tracked):
    assert profiling.tracing() is False
    _, snap = tracked[False]
    assert snap["frames"] == 0 and snap["spans"] == {} and snap["counters"] == {}
    assert snap["runs"] == [] and snap["per_frame"] == {}
    assert all(v == 0.0 for v in snap["stage_ms"].values())


def test_init_then_track_spans_stages_counters(tiny, tracked):
    res, snap = tracked[True]
    assert [r.reinitialized for r in res] == [True, False]
    assert snap["frames"] == 2
    # the point-mode scorer's particles by tier: those a pixel-mode frame renders
    assert snap["counters"] == {"init.steps": 1, "init.needed": 1, "slots.init": 1,
                                "slots.track": 1, **_points(tiny["cfg"], 1)}
    # each stage once a frame, in order
    assert snap["runs"] == [(1, profiling.STAGES), (2, profiling.STAGES)]
    assert all(snap["stage_ms"][s] > 0 for s in profiling.STAGES)
    per = snap["per_frame"]
    assert per["init_step_share"] == 50.0 and per["wasted_slot_share"] == 0.0
    assert per["coarse_points_per_frame"] == snap["counters"]["score.points.coarse"] / 2
    assert per["full_points_per_frame"] == snap["counters"]["score.points.full"] / 2
    assert sum(per[f"{s}_ms"] for s in profiling.STAGES) == pytest.approx(
        sum(snap["stage_ms"].values()) / 2)
    # the CPU replays no graph and has no card to go idle
    assert not {"kernels_per_frame", "launch_ms", "idle_ms"} & set(per)
    assert snap["idle_s"] is None


def test_spans_nest_under_their_parents(tiny):
    fr = tiny["frames"][0]
    with _Traced() as t:
        tracker = Tracker(Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"]), seed=3)
        for _ in range(2):
            tracker.step(fr.depth, fr.hand_base, fr.hand_q)
        spans = list(t.spans)
    by_frame = {}
    for name, start, end, parent, frame in spans:
        assert end is not None and end >= start
        by_frame.setdefault(frame, []).append(
            (name, spans[parent][0] if parent >= 0 else None))
    want = [("tracker.step", None), ("tracker.watchdog", "tracker.step"),
            ("tracker.priors", "tracker.step"), ("estimate", "tracker.step"),
            ("program.call", "estimate")]
    assert by_frame == {1: want, 2: want}


def test_tracker_bitwise_on_and_off(tracked):
    for a, b in zip(tracked[False][0], tracked[True][0]):
        assert a.reinitialized == b.reinitialized
        for name in ("pose", "fitness", "coverage"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name


def test_sweep_bitwise_on_and_off(tiny):
    frames = tiny["frames"]
    depths, hbs, hqs = (np.stack([getattr(f, n) for f in frames])
                        for n in ("depth", "hand_base", "hand_q"))
    out = {}
    for on in (False, True):
        with _Traced(on):
            sweep = LibrarySweep(tiny["objs"], tiny["hand"], tiny["cfg"])
            st = sweep.init_state(seed=4)
            res = []
            for _ in range(2):                  # the init step, then a tracked one
                st, r = sweep.step(st, depths, hbs, hqs)
                res.append(r)
            out[on] = (res, profiling.snapshot())
    for a, b in zip(out[False][0], out[True][0]):
        for name, x, y in zip(a._fields, a, b):
            if x is not None:
                assert torch.equal(x, y), name
    snap = out[True][1]
    assert snap["frames"] == 2 and snap["runs"] == [(1, profiling.STAGES),
                                                    (2, profiling.STAGES)]
    assert snap["counters"] == {"init.steps": 1, "init.needed": 2, "slots.init": 2,
                                "slots.track": 2, **_points(tiny["cfg"], 2)}
    names = {k: v["count"] for k, v in snap["spans"].items()}
    assert names == {"sweep.step": 2, "sweep.prep": 2, "sweep.mask_read": 2,
                     "sweep.run": 2, "program.call": 2, "sweep.merge": 2,
                     "sweep.finish": 2}


def test_mixed_sweep_step_counts():
    """Objects 1 and 5 of 8 re-initialise: the init program runs over all
    8 (6 of them wasted), beside the track program over all 8."""
    tiny = _setup("cpu", n_objects=8, particles=8, iters=1)
    fr = tiny["frames"]
    O = 8
    depths = np.stack([fr[o % 2].depth for o in range(O)])
    hbs = np.stack([fr[o % 2].hand_base for o in range(O)])
    hqs = np.stack([fr[o % 2].hand_q for o in range(O)])
    sweep = LibrarySweep(tiny["objs"], tiny["hand"], tiny["cfg"])
    st = sweep.init_state(seed=5)
    fitness = torch.ones(O)
    fitness[[1, 5]] = -1.0
    st = st._replace(poses=torch.as_tensor(np.stack([fr[o % 2].pose_gt for o in range(O)])),
                     initialized=torch.ones(O, dtype=torch.bool), fitness=fitness)
    with _Traced():
        _, res = sweep.step(st, depths, hbs, hqs)
        snap = profiling.snapshot()
    assert res.reinitialized.tolist() == [o in (1, 5) for o in range(O)]
    assert snap["counters"] == {"init.steps": 1, "init.needed": 2, "slots.init": 8,
                                "slots.track": 8, **_points(tiny["cfg"], O)}
    per = snap["per_frame"]
    assert per["init_step_share"] == 100.0
    assert per["wasted_slot_share"] == pytest.approx(100.0 * 6 / 16)
    # both programs ran in the one frame, each through all five stages
    assert snap["runs"] == [(1, profiling.STAGES)] * 2


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_self_time_and_readings_on_a_fake_clock(monkeypatch):
    clock = _Clock()
    tracer = profiling.Tracer(clock=clock)
    monkeypatch.setattr(profiling, "TRACER", tracer)
    monkeypatch.setattr(profiling, "_ON", True)
    for _ in range(2):
        with profiling.span("step", frame=True):            # 10 s
            clock.t += 1.0
            with profiling.span("a"):                       # 3 s, 1 s its own
                clock.t += 1.0
                with profiling.span("b"):                   # 2 s
                    clock.t += 2.0
            with profiling.span("a"):                       # 4 s, all its own
                clock.t += 4.0
            clock.t += 2.0
            profiling.count("slots.track", 8)
    assert tracer.open_at(1.5) == "a" and tracer.open_at(2.5) == "b"
    assert tracer.open_at(9.5) == "step" and tracer.open_at(25.0) == profiling.OUTSIDE
    # an idle gap is named by the span open when the card went idle, and
    # split over the spans the host passed through
    at_start, split = tracer.idle([(1.5, 3.5), (20.5, 22.0)])
    assert at_start == {"a": 2.0, profiling.OUTSIDE: 1.5}
    assert split == {"a": 0.5, "b": 1.5, profiling.OUTSIDE: 1.5}
    clock.t += 1.0
    snap = tracer.snapshot()
    assert snap["frames"] == 2 and snap["seconds"] == 21.0
    assert snap["spans"] == {
        "step": {"total_s": 20.0, "self_s": 6.0, "count": 2},
        "a": {"total_s": 14.0, "self_s": 10.0, "count": 4},
        "b": {"total_s": 4.0, "self_s": 4.0, "count": 2},
    }
    # no init ran: the shares read 0, not None; nothing else was measured
    assert snap["per_frame"] == {"init_step_share": 0.0, "wasted_slot_share": 0.0}
    tracer.reset()
    with profiling.span("step", frame=True):
        profiling.count("init.steps")
        profiling.count("init.needed", 2)
        profiling.count("slots.init", 8)
        profiling.count("slots.track", 8)
        profiling.stage("prep", "cpu")
        clock.t += 0.5
        profiling.stage("seed", "cpu")
        clock.t += 0.25
        profiling.stage_end("cpu")
    per = tracer.snapshot()["per_frame"]
    assert per == {"prep_ms": 500.0, "seed_ms": 250.0, "scan_ms": 0.0,
                   "polish_ms": 0.0, "finish_ms": 0.0, "init_step_share": 100.0,
                   "wasted_slot_share": 37.5}
    # a stage mark outside a marked run, or in a warm-up, records nothing
    tracer.reset()
    profiling.stage("scan", "cpu")
    with profiling.quiet():
        profiling.stage("prep", "cpu")
        profiling.stage_end("cpu")
    assert tracer.snapshot()["runs"] == []


def test_spans_are_record_function_ranges(tiny):
    """A tracked frame's spans under torch.profiler; its search is the
    result of an earlier one, so that the profiler records little else."""
    from torch.profiler import ProfilerActivity, profile

    fr = tiny["frames"][0]
    est = Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"])
    dyn, static = est.frame_args(fr.depth, fr.pose_gt, fr.hand_base, fr.hand_q,
                                 key=3)
    out = est._frame_step(*dyn, **static)
    est._frame_step = lambda *args, **kwargs: out
    tracker = Tracker(est, seed=3)
    tracker.state = tracker.state._replace(pose=fr.pose_gt, initialized=True,
                                           fitness=1.0)
    with _Traced(), profile(activities=[ProfilerActivity.CPU]) as prof:
        tracker.step(fr.depth, fr.hand_base, fr.hand_q)
    names = {e.name for e in prof.events()}
    assert {profiling.PREFIX + n for n in ("tracker.step", "tracker.watchdog",
                                           "tracker.priors", "estimate",
                                           "program.call")} <= names


def _renders(cfg, mode: str) -> tuple[int, int]:
    """The particle renders a frame of `mode` scores in pixel mode, (coarse,
    full): the prescreen (init), the swarm before and after each scan
    iteration, the explorer seeds' pick (track); the polish's candidates
    before and after it, and the finisher's batches."""
    pc, tr = cfg.pso, cfg.tracker
    P = tr.reinit_particles if mode == "init" else pc.particles
    iters = 2 * pc.iters if mode == "init" else pc.iters
    explore = int(round(P * pc.explore_frac)) if mode == "track" else 0
    coarse = (tr.reinit_prescreen if mode == "init" else 0) + (iters + 1) * P + explore
    cands = 1 + min(pc.polish_top_k, P - 1) + (1 if explore else 0) + pc.slide_proposals
    finisher = pc.finish_iters * max(2, min(pc.finish_particles, 4 * P))
    return coarse, 2 * cands + finisher


def _points(cfg, O: int) -> dict:
    """The point-mode scorer's counters of an init frame and a tracked
    frame (or program) of O objects: the particles a pixel-mode frame
    renders, by tier."""
    want = [_renders(cfg, mode) for mode in ("init", "track")]
    return {"score.points.coarse": O * sum(w[0] for w in want),
            "score.points.full": O * sum(w[1] for w in want)}


def test_pixel_mode_counts_renders_by_tier(tiny):
    """A pixel-mode init frame then a tracked frame count each particle
    render by tier, and the per-frame readings hold them; pixel mode counts
    no point scoring, and point mode no render
    (test_init_then_track_spans_stages_counters)."""
    cfg = dataclasses.replace(tiny["cfg"], score=ScoreConfig(mode="pixel"))
    fr = tiny["frames"][0]
    with _Traced():
        tracker = Tracker(Estimator(tiny["objs"][0], tiny["hand"], cfg), seed=3)
        res = [tracker.step(fr.depth, fr.hand_base, fr.hand_q) for _ in range(2)]
        snap = profiling.snapshot()
    want = [_renders(cfg, "init" if r.reinitialized else "track") for r in res]
    assert res[0].reinitialized
    c = snap["counters"]
    assert c["score.renders.coarse"] == sum(w[0] for w in want)
    assert c["score.renders.full"] == sum(w[1] for w in want)
    assert not [k for k in c if k.startswith("score.points.")]
    per = snap["per_frame"]
    assert per["coarse_renders_per_frame"] == c["score.renders.coarse"] / 2
    assert per["full_renders_per_frame"] == c["score.renders.full"] / 2


def test_capture_counts_once_per_replay():
    """What a capture counts comes back out of the counters
    (`profiling.recording`) and is counted once per replay
    (`profiling.recount`); with the tracer off nothing is counted or
    recorded, and a record's counters are not counted again."""
    with _Traced() as t:
        profiling.count("init.steps")
        before = t.counters
        with profiling.recording() as rec:
            profiling.count("score.renders.coarse", 5)        # as a capture counts
            profiling.count("score.renders.full", 2)
        assert t.counters == before == {"init.steps": 1}
        assert rec == {"score.renders.coarse": 5, "score.renders.full": 2}
        for _ in range(3):                                     # three replays
            profiling.recount(rec)
        assert t.counters == {"init.steps": 1, "score.renders.coarse": 15,
                              "score.renders.full": 6}
    with _Traced(False) as t:
        before = t.counters
        with profiling.recording() as off:
            profiling.count("score.renders.coarse", 5)
        assert before == {} and off == {}
        profiling.recount(rec)
        assert t.counters == {}


@pytest.mark.cuda
def test_traced_graph_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tiny = _setup("cuda")
    fr = tiny["frames"][0]
    args = (fr.depth, fr.pose_gt, fr.hand_base, fr.hand_q)
    res, progs = {}, {}
    for on in (False, True):
        with _Traced(on):
            est = Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"])
            res[on] = est.estimate(*args, key=5, mode="track")
            progs[on], = est._programs.programs.values()
            if on:
                est.estimate(*args, key=6, mode="track")
                snap = profiling.snapshot()
    off, on = progs[False].nodes(), progs[True].nodes()
    assert off["event_record"] == 0 and on["event_record"] == 6
    assert on["kernel"] == off["kernel"] > 0
    assert all(torch.equal(a, b) for a, b in zip(res[False], res[True]))
    assert snap["counters"]["program.replays"] == 2
    assert snap["counters"]["program.kernels"] == 2 * on["kernel"]
    assert snap["runs"] == [(0, profiling.STAGES)] * 2
    marks = progs[True].marks
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    progs[True].graph.replay()
    end.record()
    torch.cuda.synchronize()
    stages = sum(a.elapsed_time(b) for (_, a), (_, b) in zip(marks, marks[1:]))
    assert stages == pytest.approx(start.elapsed_time(end), rel=0.02)
