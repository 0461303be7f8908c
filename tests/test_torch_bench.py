"""The port's measurement surface on the CPU at the tiny size of
`__graft_entry__._tiny_setup` (64 x 48, 32 particles): every benchmark mode
of `benchmarks.py`, `cli bench` and `scripts/profile_phases_torch.py` prints
one JSON line with the reference's keys (less the XLA cost fields, plus the
device ones); `full_refine_equivalents_per_frame` equals the JAX package's
on the same configurations; `PhaseTimer.report` equals the reference's."""
import dataclasses
import functools
import importlib.util
import json
import os

import pytest
import torch

from icra20_hand_object_pose_tpu import benchmarks as jbench
from icra20_hand_object_pose_tpu.utils import config as jconfig
from icra20_hand_object_pose_tpu.utils import profiling as jprofiling
from icra20_hand_object_pose_tpu_torch import benchmarks, cli
from icra20_hand_object_pose_tpu_torch.utils import config
from icra20_hand_object_pose_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the camera, swarm and clouds of __graft_entry__._tiny_setup
TINY = dict(width=64, height=48, fov_f=57.6, particles=32, scene_points=256,
            model_points=256, render_points=512)
MAIN_KEYS = {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
             "eager_ms_per_frame", "e2e_tracker_ms_per_frame", "full_refine_equiv_per_sec",
             "device_ms_per_frame", "idle_share", "aten_calls_per_frame",
             "device", "power_limit_w"}
SWEEP_KEYS = {"metric", "value", "unit", "vs_baseline", "hyp_per_sec_chip",
              "ms_per_object_frame", "device", "power_limit_w"}
INIT_KEYS = {"metric", "value", "unit", "vs_baseline", "per_shape", "device",
             "power_limit_w"}
SHAPE_KEYS = {"success", "success_frame0", "recovered_frame1",
              "adds_mm_median_success"}


def _one_line(capsys) -> dict:
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_main_prints_reference_keys(capsys):
    rec = benchmarks.main(device="cpu", iters=3, reps=1, tracker_warmup=1, **TINY)
    out = _one_line(capsys)
    assert out == rec and set(out) == MAIN_KEYS
    assert out["metric"] == "icp_refined_pose_hypotheses_per_sec_per_chip_512p"
    assert out["unit"] == "hypotheses/sec/chip"
    assert out["value"] > 0 and out["ms_per_frame"] > 0
    assert out["eager_ms_per_frame"] > 0
    assert out["e2e_tracker_ms_per_frame"] > 0 and out["aten_calls_per_frame"] > 0
    # a CPU run names no device metric
    assert out["device"] == "cpu" and out["power_limit_w"] is None
    assert out["device_ms_per_frame"] is None and out["idle_share"] is None


@pytest.mark.parametrize("shared", [False, True])
def test_bench_sweep_prints_reference_keys(capsys, shared):
    rec = benchmarks.bench_sweep(n_objects=2, particles=32, shared=shared,
                                 device="cpu", iters=3, reps=1,
                                 reinit_particles=32, prescreen=64, **{
                                     k: v for k, v in TINY.items() if k != "particles"})
    out = _one_line(capsys)
    assert out == rec and set(out) == SWEEP_KEYS
    assert out["metric"] == ("library_sweep_objects_tracked_per_sec_2obj_32p"
                             + ("_shared_scene" if shared else ""))
    assert out["value"] > 0 and out["ms_per_object_frame"] > 0


def test_bench_init_prints_reference_keys(capsys):
    rec = benchmarks.bench_init(n_trials=1, device="cpu", shapes=("box",),
                                prescreen=64, **TINY)
    out = _one_line(capsys)
    assert out == rec and set(out) == INIT_KEYS
    assert out["metric"] == "global_init_success_per_shape_1trials_vga"
    assert set(out["per_shape"]) == {"box"}
    assert set(out["per_shape"]["box"]) == SHAPE_KEYS | {"s_per_trial"}
    assert 0.0 <= out["value"] <= 1.0


def test_bench_sweep_init_prints_reference_keys(capsys):
    rec = benchmarks.bench_sweep_init(n_trials=1, device="cpu",
                                      shapes=("box", "cylinder"), prescreen=64,
                                      **TINY)
    out = _one_line(capsys)
    assert out == rec and set(out) == INIT_KEYS | {"s_per_trial"}
    assert out["metric"] == "sweep_global_init_success_per_shape_1trials_vga"
    assert set(out["per_shape"]) == {"box", "cylinder"}
    assert all(set(v) == SHAPE_KEYS for v in out["per_shape"].values())


def test_cli_bench_runs_main_on_the_device_asked(capsys, monkeypatch):
    # the headline at the tiny size: `cli bench` only chooses the device
    monkeypatch.setattr(benchmarks, "main", functools.partial(
        benchmarks.main, iters=3, reps=1, tracker_warmup=1, **TINY))
    assert cli.main(["bench", "--device", "cpu"]) == 0
    out = _one_line(capsys)
    assert set(out) == MAIN_KEYS and out["device"] == "cpu"


def _configs(cfg_mod):
    C = cfg_mod
    vga = C.CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                             cx=320.0, cy=240.0)
    tiny_cam = C.CameraIntrinsics(width=64, height=48, fx=57.6, fy=57.6,
                                  cx=32.0, cy=24.0)
    base = C.EstimatorConfig(camera=vga, scene_points=2048,
                             pso=C.PsoConfig(particles=512, iters=10))
    tiny = C.EstimatorConfig(
        camera=tiny_cam, scene_points=256, render_size=48,
        pso=C.PsoConfig(particles=32, iters=3, icp_iters_inner=2),
        tracker=C.TrackerConfig(reinit_particles=32, reinit_prescreen=64))
    rep = dataclasses.replace
    return {
        "config3": base,
        "tiny": tiny,
        "no_explorer": rep(base, pso=rep(base.pso, explore_frac=0.0)),
        "no_scene_cov": rep(base, score=rep(base.score, scene_cov_weight=0.0)),
        "no_slides_icp_every_2": rep(base, pso=rep(base.pso, slide_proposals=1,
                                                   icp_every=2)),
        "tiny_no_explorer": rep(tiny, pso=rep(tiny.pso, explore_frac=0.0)),
    }


@pytest.mark.parametrize("name", list(_configs(config)))
def test_full_refine_equivalents_equal_reference(name):
    got = benchmarks.full_refine_equivalents_per_frame(_configs(config)[name])
    want = jbench.full_refine_equivalents_per_frame(_configs(jconfig)[name])
    assert got == want
    if name == "config3":
        assert round(got, 3) == 18.667


def test_phase_timer_report_equals_reference():
    totals = {"frame": 0.8125, "hand_tensors": 0.0321, "preprocess": 0.25}
    counts = {"frame": 8, "hand_tensors": 3, "preprocess": 8}
    ours, ref = profiling.PhaseTimer(), jprofiling.PhaseTimer()
    for t in (ours, ref):
        t.totals.update(totals)
        t.counts.update(counts)
    assert ours.report() == ref.report()
    # a timed phase accumulates, and sync waits for nothing on the CPU
    with ours.phase("frame", sync_on=(torch.zeros(2), None)):
        pass
    assert ours.counts["frame"] == 9 and ours.totals["frame"] >= 0.8125


def test_profile_counts_counts_aten_calls():
    x = torch.ones(4)
    prof = profiling.profile_counts(lambda: (x + 1) * 2, device="cpu")
    assert prof["aten_calls"] >= 2 and prof["wall_ms"] > 0
    assert prof["device_ms"] == 0.0
    assert torch.equal(prof["result"], torch.full((4,), 4.0))


def test_profile_phases_prints_every_key(capsys):
    mod = _load_script("profile_phases_torch")
    rec = mod.main(device="cpu", reps=1, **TINY)
    out = json.loads(capsys.readouterr().out)
    keys = ["hand_tensors", "preprocess", "frame_fixed+1iter (no scan, no finisher)",
            "pso_scan_9iters", "finisher", "frame_total"]
    assert out == rec
    assert set(out) == {f"{k}{s}" for k in keys
                        for s in ("", "_iqr_ms", "_device_ms", "_aten_calls")} | {
        f"{k}{s}" for k in keys[2:] for s in ("_programs", "_programs_device_ms")}
    for k in keys:
        assert out[f"{k}_device_ms"] is None            # no device on the CPU
        lo, hi = out[f"{k}_iqr_ms"]                     # one turn: no spread
        assert lo == hi == pytest.approx(out[k], abs=2e-3)
    for k in keys[2:]:
        assert out[f"{k}_programs_device_ms"] is None
    assert out["frame_total"] > 0 and out["frame_total_aten_calls"] > 0
    assert out["frame_total_programs"] > 0
