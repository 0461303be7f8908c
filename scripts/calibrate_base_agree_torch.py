#!/usr/bin/env python
"""Calibrate HandConfig.base_refine_accept_margin on the port (counterpart
of scripts/calibrate_base_agree.py).

Measures, in two regimes, (a) models/hand.config_agreement of the
REPORTED hand base against the observed depth and (b) the agreement GAIN
of models/hand.refine_base's winner over the reported base, the quantity
that the estimator's margin-accept gates on:

  calibrated    - reported base == true base, nominal q == true q, clean
                  sensor (auto-refinement must NOT arm here)
  miscalibrated - reported base = err @ true base with 3 deg / 5 mm
                  extrinsic error, q 0.15 rad off, realistic sensor

The reference's table (its docstring, measured on its own device): the
absolute score does not separate the regimes, the gain does: calibrated
gains <= +0.059, miscalibrated +0.084..+0.273, so the margin 0.08 splits
the gap. This script prints the port's gains in the reference's JSON.

Randomness: trial t's rotation comes from a torch generator seeded
100 + t and its refine from one seeded 9000 + t (the reference's
jax.random.key(100 + t) and key(9000 + t)); the numpy draws
(default_rng(3), 7000 + t, 50 + t) are the reference's own.

Usage: python3 scripts/calibrate_base_agree_torch.py [--trials 8]
           [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HQ = np.asarray([0.45, 0.45], np.float32)   # nominal joint angles
FACTOR = 4   # the VGA estimator's default lo grid (render_size 160)
REGIMES = ("calibrated", "miscalibrated")


def vga():
    from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

    return CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                            cx=320.0, cy=240.0)


def lo_grid(cam, factor: int = FACTOR) -> dict:
    """The intrinsics of the depth min-pooled by `factor`."""
    return dict(fx=cam.fx / factor, fy=cam.fy / factor, cx=cam.cx / factor,
                cy=cam.cy / factor, height=cam.height // factor,
                width=cam.width // factor)


def trial_rotation(t: int, device="cuda") -> np.ndarray:
    """Trial t's object rotation [3,3], from a generator seeded 100 + t."""
    import torch

    from icra20_hand_object_pose_tpu_torch.utils import se3

    gen = torch.Generator(device=device).manual_seed(100 + t)
    return se3.random_rotation(gen).cpu().numpy()


def ground_truth(R: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """The object pose: rotation R, a translation of three draws of `rng`
    (the reference's default_rng(3), shared across trials)."""
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = R
    gt[:3, 3] = [rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                 rng.uniform(0.40, 0.65)]
    return gt


def trial_frame(t: int, regime: str, gt: np.ndarray, mesh, hand, cam,
                device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Trial t's observed depth [H,W] and reported hand base [4,4] in
    `regime`."""
    import torch

    from icra20_hand_object_pose_tpu_torch.datasets import (
        SensorModel, hand_base_for_grasp, render_frame,
    )
    from icra20_hand_object_pose_tpu_torch.utils import se3

    hb = hand_base_for_grasp(gt)
    if regime == "calibrated":
        hb_rep, q_true, sensor, noise = hb, HQ, None, 0.001
    else:
        cal = np.random.default_rng(7000 + t)
        w = cal.normal(size=3)
        w = w / np.linalg.norm(w) * np.radians(3.0)
        v = cal.normal(size=3)
        v = v / np.linalg.norm(v) * 5e-3
        err = se3.se3_exp(torch.as_tensor(np.concatenate([w, v]),
                                          dtype=torch.float32)).numpy()
        hb_rep = (err @ hb).astype(np.float32)
        q_true = (HQ + cal.choice([-0.15, 0.15])).astype(np.float32)
        sensor, noise = SensorModel(), 0.0
    depth = render_frame(mesh, gt, hand, hb, q_true, cam, noise_sigma=noise,
                         rng=np.random.default_rng(50 + t), sensor=sensor,
                         device=device)
    return depth, hb_rep


def observed(depth: np.ndarray, device="cuda", factor: int = FACTOR):
    """The depth and its validity min-pooled to the lo grid, on `device`."""
    import torch

    from icra20_hand_object_pose_tpu_torch.ops import preprocess

    d = torch.as_tensor(depth, device=device)
    return preprocess.downsample_depth(d, (d > 0.1) & (d < 2.0), factor)


def agreement(hand, hb, d_lo, v_lo, lo: dict) -> float:
    """config_agreement of the hand at base `hb` and the nominal q."""
    import torch

    dev = d_lo.device
    cloud = hand.cloud(torch.as_tensor(hb, device=dev), torch.as_tensor(HQ, device=dev))
    return float(hand.config_agreement(cloud[None], d_lo, v_lo, **lo)[0])


def refine_gain(t: int, hand, hb_rep, d_lo, v_lo, lo: dict) -> tuple[float, float]:
    """(agreement of the reported base, refine_base's winner's gain over
    it): the search the init program's auto-arm runs, 3 rounds, from a
    generator seeded 9000 + t."""
    import torch

    dev = d_lo.device
    a_rep = agreement(hand, hb_rep, d_lo, v_lo, lo)
    refined = hand.refine_base(
        torch.Generator(device=dev).manual_seed(9000 + t), d_lo, v_lo,
        torch.as_tensor(hb_rep, device=dev), torch.as_tensor(HQ, device=dev),
        iters=3, **lo)
    return a_rep, agreement(hand, refined, d_lo, v_lo, lo) - a_rep


def summary(rows: dict) -> dict:
    """The reference's JSON: per regime the score range and the gains."""
    out = {}
    for k, v in rows.items():
        scores = [s for s, _ in v]
        gains = [g for _, g in v]
        out[k] = {
            "score_min": round(min(scores), 3),
            "score_max": round(max(scores), 3),
            "gain_min": round(min(gains), 3),
            "gain_median": round(float(np.median(gains)), 3),
            "gain_max": round(max(gains), 3),
            "gains": [round(x, 3) for x in gains],
        }
    return out


def run(trials: int = 8, device="cuda", cam=None) -> dict:
    """`trials` trials of both regimes on the box with the T42 hand at
    `cam` (VGA by default); prints the JSON and returns it."""
    from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
    from icra20_hand_object_pose_tpu_torch.utils import meshio

    cam = cam or vga()
    lo = lo_grid(cam)
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(device=device)
    rng = np.random.default_rng(3)
    rows = {r: [] for r in REGIMES}
    for t in range(trials):
        gt = ground_truth(trial_rotation(t, device), rng)
        for regime in REGIMES:
            depth, hb_rep = trial_frame(t, regime, gt, mesh, hand, cam, device)
            d_lo, v_lo = observed(depth, device)
            rows[regime].append(refine_gain(t, hand, hb_rep, d_lo, v_lo, lo))
    out = summary(rows)
    print(json.dumps(out, indent=2), flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a machine without a card)")
    a = ap.parse_args(argv)
    return run(a.trials, a.device)


if __name__ == "__main__":
    main()
