#!/usr/bin/env python
"""Per-phase time of the port's tracked frame on one device (counterpart of
scripts/profile_phases.py), at BASELINE config 3.

The frame's phases are isolated by running ablated variants and
differencing:

    hand_tensors  = Estimator._hand_tensors alone  (VGA hand splat + FK)
    preprocess    = preprocess_frame alone
    no_scan       = frame with pso iters=1, finish_iters=0  -> fixed costs
    no_fin        = frame with finish_iters=0               -> + PSO scan
    full          = the production frame                    -> + finisher

The split reads the frame run eagerly, one ATen operator at a time:
`Estimator._frame_step` on `frame_args` of an int seed, as the hand and
preprocessing parts run. Each frame variant also runs as `estimate` does on
the card, as a replayed program (utils/program.py), into the
`<key>_programs` keys: a replay issues none of the frame's operators, so
only its wall and device ms are split.

Each is timed with utils/profiling.PhaseTimer (a wait for the card at the
end of every call): one warm-up call (for a program, its capture), then
`reps` calls. The frame variants take their reps in turns (no_scan, no_fin,
full, each eager and replayed, then again), so that a drift of the host's
speed falls on all of them alike: the eager frame is host-bound and its
differences are small beside such drift. Each is also run once under
torch.profiler: `<key>_device_ms` (a lower bound: the profiler loses events
of few-microsecond kernels) and `<key>_aten_calls`, differenced like the
times. `<key>_iqr_ms` is the spread of the wall time over the turns: the
quartiles of the per-turn values (for the scan and the finisher, of the
per-turn differences). A wall-time part whose spread reaches 0 is not
resolved; its device ms and ATen calls still are.

    python3 scripts/profile_phases_torch.py [--device cuda] [--reps 8]

Prints one JSON object (ms).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCAN, FIXED, FINISH = ("pso_scan_9iters", "frame_fixed+1iter (no scan, no finisher)",
                       "finisher")


def main(device="cuda", *, width: int = 640, height: int = 480,
         fov_f: float = 570.0, particles: int = 512, scene_points: int = 2048,
         model_points: int = 1024, render_points: int = 2048,
         reps: int = 8) -> dict:
    from icra20_hand_object_pose_tpu_torch.datasets import (
        default_object_pose, hand_base_for_grasp, render_frame_fast,
    )
    from icra20_hand_object_pose_tpu_torch.models import (
        Estimator, ObjectModel, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu_torch.ops import preprocess
    from icra20_hand_object_pose_tpu_torch.utils import meshio
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig,
    )
    from icra20_hand_object_pose_tpu_torch.utils.profiling import (
        PhaseTimer, profile_counts,
    )

    cam = CameraIntrinsics(width=width, height=height, fx=fov_f, fy=fov_f,
                           cx=width / 2, cy=height / 2)
    base_pso = PsoConfig(particles=particles, iters=10)
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(device=device)
    obj = ObjectModel(mesh, model_points=model_points, render_points=render_points,
                      device=device)
    pose_gt = default_object_pose()
    hb = hand_base_for_grasp(pose_gt)
    hq = np.asarray([0.45, 0.45], np.float32)

    def est_for(pso_cfg):
        cfg = EstimatorConfig(camera=cam, scene_points=scene_points, pso=pso_cfg)
        return Estimator(obj, hand, cfg)

    est = est_for(base_pso)
    depth, prev, hbt, hqt = (est._tensor(a) for a in (
        render_frame_fast(mesh, pose_gt, hand, hb, hq, cam, noise_sigma=0.001,
                          device=device), pose_gt, hb, hq))
    timer = PhaseTimer()
    turns = defaultdict(list)           # ms of each timed call, by variant

    @torch.no_grad()
    def measure(fns: dict) -> None:
        """Warm each of `fns` up, then `reps` rounds of one timed call each."""
        for fn in fns.values():
            timer.sync(fn())
        for _ in range(reps):
            for name, fn in fns.items():
                t0 = timer.totals[name]
                with timer.phase(name) as t:
                    t.sync(fn())
                turns[name].append(1000.0 * (timer.totals[name] - t0))

    gen = torch.Generator(device=est.device).manual_seed(0)

    def frame(e, eager):
        seeds = iter(range(1 << 30))
        if eager:
            def run():
                dyn, static = e.frame_args(depth, prev, hbt, hqt, key=next(seeds),
                                           mode="track")
                return e._frame_step(*dyn, **static)
            return run
        return lambda: e.estimate(depth, prev, hbt, hqt, key=next(seeds),
                                  mode="track")

    variants = {"no_scan": est_for(dataclasses.replace(base_pso, iters=1,
                                                       finish_iters=0)),
                "no_fin": est_for(dataclasses.replace(base_pso, finish_iters=0)),
                "full": est}
    fns = {
        "hand_tensors": lambda: est._hand_tensors(gen, hbt, hqt, depth),
        "preprocess": lambda: preprocess.preprocess_frame(
            gen, depth, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            depth_min=0.1, depth_max=2.0, n_points=scene_points,
            render_factor=est.render_factor),
        **{k: frame(e, True) for k, e in variants.items()},
        **{f"{k}_programs": frame(e, False) for k, e in variants.items()},
    }
    measure({k: fns[k] for k in ("hand_tensors", "preprocess")})
    measure({k: fns[k] for k in fns if k not in ("hand_tensors", "preprocess")})
    ms = {k: 1000.0 * timer.totals[k] / timer.counts[k] for k in fns}
    with torch.no_grad():
        profs = {k: profile_counts(fn, device=device) for k, fn in fns.items()}
    dev_ms = {k: p["device_ms"] for k, p in profs.items()}
    calls = {k: p["aten_calls"] for k, p in profs.items()}

    def split(d, suffix=""):
        return {FIXED: d["no_scan" + suffix],
                SCAN: d["no_fin" + suffix] - d["no_scan" + suffix],
                FINISH: d["full" + suffix] - d["no_fin" + suffix],
                "frame_total": d["full" + suffix]}

    def parts(d):
        return {"hand_tensors": d["hand_tensors"], "preprocess": d["preprocess"],
                **split(d)}

    on_card = torch.device(device).type == "cuda"
    iqr = parts({k: np.asarray(v) for k, v in turns.items()})
    rec = {}
    for (key, t), d, n in zip(parts(ms).items(), parts(dev_ms).values(),
                              parts(calls).values()):
        rec[key] = round(t, 3)
        rec[f"{key}_iqr_ms"] = [round(float(q), 3)
                                for q in np.percentile(iqr[key], [25, 75])]
        rec[f"{key}_device_ms"] = round(d, 3) if on_card else None
        rec[f"{key}_aten_calls"] = n
    for (key, t), d in zip(split(ms, "_programs").items(),
                           split(dev_ms, "_programs").values()):
        rec[f"{key}_programs"] = round(t, 3)
        rec[f"{key}_programs_device_ms"] = round(d, 3) if on_card else None
    print(json.dumps(rec, indent=1), flush=True)
    print(timer.report(), file=sys.stderr, flush=True)
    return rec


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a machine without a card)")
    ap.add_argument("--reps", type=int, default=8)
    a = ap.parse_args()
    main(device=a.device, reps=a.reps)
