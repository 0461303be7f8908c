"""Pose-accuracy evaluation: ADD / ADD-S metrics, curves, summaries.

The reference validates by comparing estimated pose trajectories against
ground truth with ADD / ADD-S curves as published in its ICRA'20 paper
(SURVEY.md §5: "running the released binary on the released dataset
sequences and comparing against ground-truth poses (ADD/ADD-S curves)").
This module is the rebuild's equivalent harness, host-side numpy: exact,
dependency-free, works on synthetic GT (machine-precision ground truth)
and recorded sequences alike.

Definitions (Hinterstoisser et al.; used by the reference's paper):
  ADD    = mean_i |T_est p_i - T_gt p_i|            (asymmetric objects)
  ADD-S  = mean_i min_j |T_est p_i - T_gt p_j|      (symmetry-agnostic)
  AUC    = normalized area under the accuracy-vs-threshold curve,
           thresholds 0..max_threshold (default 0.1 m, as in PoseCNN).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Sequence

import numpy as np


def add_error(T_est: np.ndarray, T_gt: np.ndarray, pts: np.ndarray) -> float:
    a = pts @ np.asarray(T_est)[:3, :3].T + np.asarray(T_est)[:3, 3]
    b = pts @ np.asarray(T_gt)[:3, :3].T + np.asarray(T_gt)[:3, 3]
    return float(np.mean(np.linalg.norm(a - b, axis=-1)))


def add_s_error(T_est: np.ndarray, T_gt: np.ndarray, pts: np.ndarray) -> float:
    """Symmetric ADD: mean closest-point distance (KD-tree).

    NOTE: ADD-S has a resolution floor of roughly half the model point
    spacing — at 1024 samples on a 5 cm object that is ~2.6 mm for a
    symmetry-flipped but otherwise exact pose. Use a dense cloud
    (>= 4096, see `evaluate_trajectory(eval_points=...)`) when measuring
    millimeter-level accuracy.
    """
    from scipy.spatial import cKDTree

    a = pts @ np.asarray(T_est)[:3, :3].T + np.asarray(T_est)[:3, 3]
    b = pts @ np.asarray(T_gt)[:3, :3].T + np.asarray(T_gt)[:3, 3]
    d, _ = cKDTree(b).query(a, k=1)
    return float(np.mean(d))


def add_sym_error(
    T_est: np.ndarray, T_gt: np.ndarray, pts: np.ndarray,
    symmetries: Sequence[np.ndarray],
) -> float:
    """Symmetry-group-aware ADD: min over the object's discrete symmetry
    transforms S of ADD(T_est, T_gt @ S).

    Exact where ADD-S only bounds: sampled-cloud ADD-S floors at ~half
    the sample spacing under a symmetry flip (~0.9 mm at 8192 points —
    measured r2, see make_asym), because the flipped sample set lands
    BETWEEN the original samples. With the symmetry group given, the
    flip is removed analytically and plain point-to-point ADD applies.
    `symmetries` should include the identity.
    """
    return min(add_error(T_est, np.asarray(T_gt) @ S, pts) for S in symmetries)


def symmetry_group(kind: str) -> list[np.ndarray]:
    """Discrete rotational symmetries of the procedural test objects
    (4x4 transforms, identity included). For 'cylinder'/'sphere' the
    continuous symmetry is not enumerable — use ADD-S there. The group
    itself is catalogued once in utils.meshio.object_symmetry_group
    (which also feeds the tracker's symmetry-branch snap via
    Mesh.symmetries); this wrapper keeps the metric-side API."""
    from .utils.meshio import object_symmetry_group

    if kind in ("cylinder", "sphere"):
        raise ValueError(f"no discrete symmetry group catalogued for {kind!r}")
    group = object_symmetry_group(kind)   # raises on unknown kinds
    if group is None:                     # trivial (asym / concave set)
        return [np.eye(4)]
    return [np.asarray(S, np.float64) for S in group]


def rotation_error_deg(T_est: np.ndarray, T_gt: np.ndarray) -> float:
    R = np.asarray(T_est)[:3, :3] @ np.asarray(T_gt)[:3, :3].T
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


def translation_error(T_est: np.ndarray, T_gt: np.ndarray) -> float:
    return float(
        np.linalg.norm(np.asarray(T_est)[:3, 3] - np.asarray(T_gt)[:3, 3])
    )


def accuracy_curve(
    errors: Sequence[float], max_threshold: float = 0.1, n: int = 200
) -> tuple[np.ndarray, np.ndarray]:
    """(thresholds, fraction-of-frames-below-threshold)."""
    e = np.asarray(errors, np.float64)
    ts = np.linspace(0.0, max_threshold, n)
    acc = (e[None, :] <= ts[:, None]).mean(axis=1)
    return ts, acc


def auc(errors: Sequence[float], max_threshold: float = 0.1) -> float:
    """Normalized area under the accuracy curve in [0, 1]."""
    ts, acc = accuracy_curve(errors, max_threshold)
    return float(np.trapezoid(acc, ts) / max_threshold)


@dataclass
class TrajectorySummary:
    n_frames: int
    add_mean: float
    add_s_mean: float
    add_s_median: float
    add_s_auc_10cm: float
    success_rate_10pct_diam: float   # ADD-S < 0.1 * object diameter
    rot_err_deg_mean: float
    trans_err_mean: float

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def __str__(self) -> str:
        return (
            f"frames={self.n_frames} ADD={self.add_mean*1000:.2f}mm "
            f"ADD-S={self.add_s_mean*1000:.2f}mm "
            f"(median {self.add_s_median*1000:.2f}mm) "
            f"AUC@10cm={self.add_s_auc_10cm:.3f} "
            f"succ@0.1d={self.success_rate_10pct_diam:.1%} "
            f"rot={self.rot_err_deg_mean:.2f}deg "
            f"trans={self.trans_err_mean*1000:.2f}mm"
        )


def evaluate_trajectory(
    poses_est: Sequence[np.ndarray],
    poses_gt: Sequence[np.ndarray],
    model_pts: np.ndarray,
    diameter: float,
    mesh=None,
    eval_points: int = 8192,
) -> TrajectorySummary:
    """When `mesh` (utils.meshio.Mesh) is given, metrics use a dense
    `eval_points` surface sampling instead of `model_pts`, avoiding the
    ADD-S sampling floor (see add_s_error)."""
    if len(poses_est) != len(poses_gt):
        raise ValueError(
            f"{len(poses_est)} estimated vs {len(poses_gt)} GT poses"
        )
    if mesh is not None:
        model_pts, _ = mesh.sample_surface(eval_points, seed=123)
    pts = np.asarray(model_pts, np.float64)
    adds, add_ss, rots, trans = [], [], [], []
    for Te, Tg in zip(poses_est, poses_gt):
        adds.append(add_error(Te, Tg, pts))
        add_ss.append(add_s_error(Te, Tg, pts))
        rots.append(rotation_error_deg(Te, Tg))
        trans.append(translation_error(Te, Tg))
    add_ss_a = np.asarray(add_ss)
    return TrajectorySummary(
        n_frames=len(poses_est),
        add_mean=float(np.mean(adds)),
        add_s_mean=float(np.mean(add_ss_a)),
        add_s_median=float(np.median(add_ss_a)),
        add_s_auc_10cm=auc(add_ss, 0.1),
        success_rate_10pct_diam=float(np.mean(add_ss_a < 0.1 * diameter)),
        rot_err_deg_mean=float(np.mean(rots)),
        trans_err_mean=float(np.mean(trans)),
    )


class JsonlLogger:
    """Structured per-frame records (SURVEY.md §6 metrics/observability):
    one JSON object per line — pose, fitness, errors vs GT, timing."""

    def __init__(self, path: str):
        self._f = open(path, "w")

    def log(self, **record) -> None:
        def clean(v):
            if isinstance(v, np.ndarray):
                return v.tolist()
            if isinstance(v, (np.floating, np.integer)):
                return v.item()
            return v

        self._f.write(json.dumps({k: clean(v) for k, v in record.items()}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
