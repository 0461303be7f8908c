#!/usr/bin/env python
"""A/B on the port: in-scan ICP search cadence and subset sizes against
frame time and tracked ADD (counterpart of scripts/ab_scan_icp.py).

Each variant is measured for both wall time and tracked accuracy on the
noisy asym sequence:

  base   : icp_iters_inner=2, gn_reps=2, subsets 512/512  (production)
  i1r3   : 1 search/iter, 3 GN reps            (half the searches)
  i1r4   : 1 search/iter, 4 GN reps
  m256   : subsets 512 scene / 256 model       (half the acc tile)
  i1r3m256: both
  i1r3m256f4, i1r3m256s768: with 4 finisher rounds, with 768 scene points

Latency: the track program (`Estimator.estimate`, mode "track") on a
splat-rendered frame, one warm-up frame, then 8 frames with keys 1..8,
the loop ending in the pose copied to the host (as `benchmarks.main`
times its frame). Accuracy: a Tracker seeded at the ground truth over
`generate_sequence(seed=3 + s)` per seed.

Usage: python3 scripts/ab_scan_icp_torch.py [--frames 8] [--seeds 2]
           [--only base,i1r3] [--shape asym] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# name -> (PsoConfig fields, IcpConfig fields)
VARIANTS = {
    "base": ({}, {}),
    "i1r3": ({"icp_iters_inner": 1}, {"gn_reps": 3}),
    "i1r4": ({"icp_iters_inner": 1}, {"gn_reps": 4}),
    "m256": ({"icp_model_subset": 256}, {}),
    "i1r3m256": ({"icp_iters_inner": 1, "icp_model_subset": 256},
                 {"gn_reps": 3}),
    "i1r3m256f4": ({"icp_iters_inner": 1, "icp_model_subset": 256,
                    "finish_iters": 4},
                   {"gn_reps": 3}),
    "i1r3m256s768": ({"icp_iters_inner": 1, "icp_model_subset": 256,
                      "icp_scene_subset": 768},
                     {"gn_reps": 3}),
}


def run_variant(name, pso_kw, icp_kw, frames, seeds, shape="asym", *,
                device="cuda", width: int = 640, height: int = 480,
                fov_f: float = 570.0, scene_points: int = 2048,
                particles: int = 512, model_points: int = 1024,
                render_points: int = 2048, reps: int = 8) -> dict:
    """One variant's latency and tracked accuracy; prints and returns its
    JSON record."""
    from icra20_hand_object_pose_tpu_torch.datasets import (
        SyntheticSequenceConfig, default_object_pose, generate_sequence,
        hand_base_for_grasp, render_frame_fast,
    )
    from icra20_hand_object_pose_tpu_torch.evaluation import add_error
    from icra20_hand_object_pose_tpu_torch.models import (
        Estimator, ObjectModel, Tracker, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu_torch.utils import meshio
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig, IcpConfig, PsoConfig,
    )

    cam = CameraIntrinsics(width=width, height=height, fx=fov_f, fy=fov_f,
                           cx=width / 2, cy=height / 2)
    cfg = EstimatorConfig(
        camera=cam, scene_points=scene_points,
        pso=dataclasses.replace(PsoConfig(particles=particles, iters=10), **pso_kw),
        icp=dataclasses.replace(IcpConfig(), **icp_kw),
    )
    mesh = meshio.make_test_object(shape)
    obj = ObjectModel(mesh, model_points=model_points, render_points=render_points,
                      device=device)
    hand = make_t42_hand(device=device)
    est = Estimator(obj, hand, cfg)
    dense, _ = mesh.sample_surface(8192, seed=123)
    hq = np.asarray([0.45, 0.45], np.float32)

    # latency: the track program on one frame, on the device once
    pose_gt = default_object_pose()
    hb = hand_base_for_grasp(pose_gt)
    depth, prev, hb_t, hq_t = (est._tensor(a) for a in (
        render_frame_fast(mesh, pose_gt, hand, hb, hq, cam, noise_sigma=0.001,
                          device=device), pose_gt, hb, hq))
    est.estimate(depth, prev, hb_t, hq_t, key=0, mode="track").pose.cpu()
    t0 = time.perf_counter()
    for i in range(reps):
        out = est.estimate(depth, prev, hb_t, hq_t, key=i + 1, mode="track")
    out.pose.cpu()
    ms = (time.perf_counter() - t0) / reps * 1000.0

    # accuracy: noisy tracked sequence, ground-truth-seeded Tracker
    errs = []
    for seed in range(seeds):
        seq_cfg = SyntheticSequenceConfig(
            n_frames=frames, camera=cam, noise_sigma=0.001, dropout=0.02,
            seed=3 + seed,
        )
        frs = generate_sequence(mesh, hand, seq_cfg, device=device)
        tracker = Tracker(est, seed=seed)
        tracker.state = tracker.state._replace(
            pose=est._tensor(frs[0].pose_gt), initialized=True, fitness=1.0)
        for fr in frs:
            res = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
            errs.append(add_error(res.pose.cpu().numpy(), fr.pose_gt, dense))
    e = np.asarray(errs) * 1000.0
    rec = {"variant": name, "shape": shape,
           "ms_per_frame": round(ms, 2),
           "tracked_add_mm": round(float(e.mean()), 3),
           "add_mm_median": round(float(np.median(e)), 3),
           "add_mm_p90": round(float(np.quantile(e, 0.9)), 3),
           "n_over_5mm": int((e > 5.0).sum()),
           "n_err": len(errs)}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--only", type=str, default=None)
    ap.add_argument("--shape", type=str, default="asym")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a machine without a card)")
    args = ap.parse_args(argv)
    return [run_variant(name, pso_kw, icp_kw, args.frames, args.seeds,
                        shape=args.shape, device=args.device)
            for name, (pso_kw, icp_kw) in VARIANTS.items()
            if not args.only or name in args.only.split(",")]


if __name__ == "__main__":
    main()
