#!/usr/bin/env python
"""Tracking accuracy on the port (counterpart of scripts/eval_accuracy.py):
dense-cloud ADD-S of full tracking over synthetic VGA T42 grasp sequences
(exact ground truth), clean and noisy. `generate_sequence` gives the
reference's sequence from the same seed, so the frames equal the
reference's.

    python3 scripts/eval_accuracy_torch.py [--frames 8] [--shape ellipsoid]
        [--particles 512] [--no-subpixel] [--noise clean|noisy|both]
        [--init-gt] [--device cuda]

Noisy = 1 mm depth sigma + 2% dropout (the BASELINE-table condition).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(shape: str, noise: bool, subpixel: bool, frames: int,
        particles: int, init_gt: bool = False, n_hyp: int = 1,
        motion_prior: float | None = None,
        tau_fine: float | None = None, seed: int = 3,
        realistic: bool = False,
        joint_sigma: float | None = None,
        fused_gn: bool = False,
        finisher: str | None = None,
        base_refine: int = -1,
        self_occ: bool = True, *,
        device="cuda", width: int = 640, height: int = 480,
        fov_f: float = 570.0, scene_points: int = 2048,
        reinit_particles: int | None = None,
        prescreen: int | None = None) -> dict:
    """One tracked sequence; prints and returns its JSON record.
    reinit_particles / prescreen None keep TrackerConfig's defaults."""
    from icra20_hand_object_pose_tpu_torch.datasets import (
        SensorModel, SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu_torch.evaluation import (
        add_error, add_s_error, add_sym_error, rotation_error_deg,
        symmetry_group, translation_error,
    )
    from icra20_hand_object_pose_tpu_torch.models import (
        Estimator, ObjectModel, Tracker, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu_torch.utils import meshio
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig, HandConfig, IcpConfig, PsoConfig,
        ScoreConfig, TrackerConfig,
    )

    cam = CameraIntrinsics(width=width, height=height, fx=fov_f, fy=fov_f,
                           cx=width / 2, cy=height / 2)
    score_kw = dict(subpixel=subpixel, self_occlusion=self_occ)
    if tau_fine is not None:
        score_kw["depth_tau_fine"] = tau_fine
    tracker_kw = dict(n_hypotheses=n_hyp)
    if motion_prior is not None:
        tracker_kw["motion_prior"] = motion_prior
    if reinit_particles is not None:
        tracker_kw["reinit_particles"] = reinit_particles
    if prescreen is not None:
        tracker_kw["reinit_prescreen"] = prescreen
    extra = {}
    if joint_sigma is not None or (realistic and base_refine != 0):
        hkw = {}
        if joint_sigma is not None:
            hkw["joint_sigma"] = joint_sigma
        if realistic and base_refine != 0:
            # calibration error regime: the hand-mount base search on (3
            # rounds by default; --base-refine 0 turns it off for an A/B)
            hkw["base_refine_iters"] = base_refine if base_refine > 0 else 3
        extra["hand"] = HandConfig(**hkw)
    if fused_gn:
        extra["icp"] = IcpConfig(fused_gn=True)
    pso_kw = dict(particles=particles, iters=10)
    if finisher:
        fi, fp, fr = (int(x) for x in finisher.split(","))
        pso_kw.update(finish_iters=fi, finish_particles=fp,
                      finish_sigma_rungs=fr)
    cfg = EstimatorConfig(
        camera=cam, scene_points=scene_points,
        pso=PsoConfig(**pso_kw),
        score=ScoreConfig(**score_kw),
        tracker=TrackerConfig(**tracker_kw),
        **extra,
    )
    mesh = meshio.make_test_object(shape)
    hand = make_t42_hand(device=device)
    if realistic:
        # the full sensor model (1 mm quantization, z^2 noise, lateral edge
        # jitter) and a hand calibration error (base 5 mm / 3 degrees off,
        # nominal joints 0.15 rad off the true closure)
        seq_cfg = SyntheticSequenceConfig(
            n_frames=frames, camera=cam,
            sensor=SensorModel(noise_sigma=0.001 if noise else 0.0,
                               dropout=0.02 if noise else 0.0),
            hand_base_err_mm=5.0, hand_base_err_deg=3.0,
            hand_q_true_offset=0.15, seed=seed,
        )
    else:
        seq_cfg = SyntheticSequenceConfig(
            n_frames=frames, camera=cam,
            noise_sigma=0.001 if noise else 0.0,
            dropout=0.02 if noise else 0.0, seed=seed,
        )
    try:
        sym_group = symmetry_group(shape)
    except ValueError:
        sym_group = None

    frs = generate_sequence(mesh, hand, seq_cfg, device=device)
    tracker = Tracker(Estimator(ObjectModel(mesh, device=device), hand, cfg), seed=0)
    if init_gt:
        # the standard tracking protocol: the first pose is given, which
        # isolates tracking accuracy from single-frame global-init ambiguity
        tracker.state = tracker.state._replace(
            pose=tracker.est._tensor(frs[0].pose_gt), initialized=True,
            fitness=1.0)
    dense, _ = mesh.sample_surface(8192, seed=123)
    errs, adds, rots, trs, sym_errs = [], [], [], [], []
    t0 = time.perf_counter()
    for fr in frs:
        out = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
        P = out.pose.cpu().numpy()
        errs.append(add_s_error(P, fr.pose_gt, dense))
        if sym_group is not None:
            sym_errs.append(add_sym_error(P, fr.pose_gt, dense, sym_group))
        adds.append(add_error(P, fr.pose_gt, dense))
        rots.append(rotation_error_deg(P, fr.pose_gt))
        trs.append(translation_error(P, fr.pose_gt))
    dt = time.perf_counter() - t0
    rec = dict(
        shape=shape, noise=noise, subpixel=subpixel, frames=frames,
        init_gt=init_gt, n_hyp=n_hyp, realistic=realistic,
        adds_mm=[round(e * 1000, 3) for e in errs],
        adds_mm_mean=round(float(np.mean(errs)) * 1000, 3),
        adds_mm_tracked_mean=round(float(np.mean(errs[1:])) * 1000, 3),
        # sampled-cloud ADD-S floors near half the sample spacing (~0.9 mm
        # at 8192 points) on a symmetry flip; ADD, rotation and translation
        # are floor-free but only meaningful on 'asym'
        add_mm_mean=round(float(np.mean(adds)) * 1000, 3),
        # symmetry-aware ADD: exact even on a symmetry flip
        sym_add_mm_mean=(round(float(np.mean(sym_errs)) * 1000, 3)
                         if sym_errs else None),
        rot_deg_mean=round(float(np.mean(rots)), 3),
        trans_mm_mean=round(float(np.mean(trs)) * 1000, 3),
        s_total=round(dt, 1),
    )
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--shape", default="ellipsoid")
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--no-subpixel", action="store_true")
    ap.add_argument("--init-gt", action="store_true",
                    help="first pose given (standard tracking protocol)")
    ap.add_argument("--hyp", type=int, default=1,
                    help="tracker hypotheses (competing basins)")
    ap.add_argument("--noise", default="both", choices=["clean", "noisy", "both"])
    ap.add_argument("--motion-prior", type=float, default=None,
                    help="override TrackerConfig.motion_prior (A/B)")
    ap.add_argument("--tau-fine", type=float, default=None,
                    help="override ScoreConfig.depth_tau_fine (A/B; 0=off)")
    ap.add_argument("--seed", type=int, default=3, help="sequence seed")
    ap.add_argument("--realistic", action="store_true",
                    help="full sensor model + hand calibration error")
    ap.add_argument("--joint-sigma", type=float, default=None,
                    help="override HandConfig.joint_sigma (A/B)")
    ap.add_argument("--fused-gn", action="store_true",
                    help="in-scan refine via the fused NN+GN kernel K3 (A/B)")
    ap.add_argument("--finisher", default=None,
                    help="override finisher shape as iters,particles,rungs")
    ap.add_argument("--base-refine", type=int, default=-1,
                    help="hand-base refine rounds in --realistic mode "
                         "(-1 = auto 3, 0 = off for A/B)")
    ap.add_argument("--no-self-occ", action="store_true",
                    help="disable ScoreConfig.self_occlusion (A/B)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a machine without a card)")
    a = ap.parse_args(argv)
    noises = {"clean": [False], "noisy": [True], "both": [False, True]}[a.noise]
    for n in noises:
        run(a.shape, n, not a.no_subpixel, a.frames, a.particles, a.init_gt,
            a.hyp, a.motion_prior, a.tau_fine, a.seed, a.realistic,
            a.joint_sigma, a.fused_gn, a.finisher, a.base_refine,
            not a.no_self_occ, device=a.device)


if __name__ == "__main__":
    main()
