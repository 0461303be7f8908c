"""Parity harness: compare a pose stream against another implementation's
dump (counterpart of parity.py, copied: numpy and `evaluation` only).

  1. `load_pose_dump(path)` reads a directory of per-frame 4x4 .txt files,
     a single stacked .txt, a .jsonl with "pose" records (this package's
     metrics.jsonl), or .npy/.npz.
  2. `compare_pose_sequences(est, ref, ...)` produces a ParityReport:
     per-frame rotation/translation deltas, ADD/ADD-S when a model cloud is
     given, and an "identical within tolerance" count.

Wired into the CLI: `cli eval --ref-poses <dump>` prints the report next to
the ground-truth metrics; that is how the port's poses are held against the
JAX package's on one recorded sequence.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

import numpy as np

from .evaluation import (
    add_error, add_s_error, rotation_error_deg, translation_error,
)


def load_pose_dump(path: str) -> list[np.ndarray]:
    """Read a sequence of [4,4] poses from any supported dump layout.

    Supported: directory of ``*.txt`` 4x4 files (sorted by name),
    ``.jsonl`` with a "pose" field per line, ``.npy``/``.npz`` arrays of
    shape [N,4,4], or a single ``.txt`` of N stacked 4x4 blocks.
    """
    if os.path.isdir(path):
        names = sorted(n for n in os.listdir(path) if n.endswith(".txt"))
        if not names:
            raise FileNotFoundError(f"no .txt pose files under {path}")
        return [
            np.loadtxt(os.path.join(path, n)).reshape(4, 4).astype(np.float64)
            for n in names
        ]
    if path.endswith(".jsonl"):
        poses = []
        with open(path) as f:
            for line in f:
                if line.strip():
                    poses.append(np.asarray(json.loads(line)["pose"], np.float64))
        return poses
    if path.endswith(".npy"):
        arr = np.load(path)
        return [p.astype(np.float64) for p in arr.reshape(-1, 4, 4)]
    if path.endswith(".npz"):
        z = np.load(path)
        key = "poses" if "poses" in z else list(z.keys())[0]
        return [p.astype(np.float64) for p in z[key].reshape(-1, 4, 4)]
    if path.endswith(".txt"):
        arr = np.loadtxt(path)
        return [p.astype(np.float64) for p in arr.reshape(-1, 4, 4)]
    raise ValueError(f"unrecognized pose dump: {path}")


@dataclass
class FrameDelta:
    frame: int
    rot_deg: float
    trans_m: float
    add_m: float | None
    add_s_m: float | None
    identical: bool


@dataclass
class ParityReport:
    n_frames: int
    n_identical: int
    rot_deg_mean: float
    rot_deg_max: float
    trans_mean: float
    trans_max: float
    add_s_mean: float | None
    add_s_max: float | None
    per_frame: list[FrameDelta]

    @property
    def identical(self) -> bool:
        return self.n_identical == self.n_frames

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["identical"] = self.identical
        return d

    def __str__(self) -> str:
        adds = (
            f" ADD-S mean={self.add_s_mean*1000:.3f}mm"
            f" max={self.add_s_max*1000:.3f}mm"
            if self.add_s_mean is not None else ""
        )
        return (
            f"parity: {self.n_identical}/{self.n_frames} identical"
            f" | rot mean={self.rot_deg_mean:.4f}deg max={self.rot_deg_max:.4f}deg"
            f" | trans mean={self.trans_mean*1000:.3f}mm"
            f" max={self.trans_max*1000:.3f}mm{adds}"
        )


def compare_pose_sequences(
    poses_est,
    poses_ref,
    model_pts: np.ndarray | None = None,
    *,
    rot_tol_deg: float = 0.1,
    trans_tol: float = 1e-4,
) -> ParityReport:
    """Frame-by-frame delta between two pose trajectories.

    `identical` uses rotation/translation tolerances (defaults: 0.1 deg /
    0.1 mm — far below any physical accuracy claim, loose enough to
    absorb f32-vs-f64 and TPU-vs-CPU arithmetic differences). ADD/ADD-S
    deltas are included when `model_pts` is given, since symmetric
    objects can differ by a symmetry transform while being equally
    correct — ADD-S is the fair cross-implementation metric.
    """
    if len(poses_est) != len(poses_ref):
        raise ValueError(
            f"{len(poses_est)} estimated vs {len(poses_ref)} reference poses"
        )
    per_frame: list[FrameDelta] = []
    for i, (Te, Tr) in enumerate(zip(poses_est, poses_ref)):
        rot = rotation_error_deg(Te, Tr)
        tr = translation_error(Te, Tr)
        a = add_error(Te, Tr, model_pts) if model_pts is not None else None
        s = add_s_error(Te, Tr, model_pts) if model_pts is not None else None
        per_frame.append(FrameDelta(
            frame=i, rot_deg=rot, trans_m=tr, add_m=a, add_s_m=s,
            identical=(rot <= rot_tol_deg and tr <= trans_tol),
        ))
    rots = np.asarray([d.rot_deg for d in per_frame])
    trs = np.asarray([d.trans_m for d in per_frame])
    has_adds = model_pts is not None and per_frame
    adds = np.asarray([d.add_s_m for d in per_frame]) if has_adds else None
    return ParityReport(
        n_frames=len(per_frame),
        n_identical=sum(d.identical for d in per_frame),
        rot_deg_mean=float(rots.mean()) if per_frame else 0.0,
        rot_deg_max=float(rots.max()) if per_frame else 0.0,
        trans_mean=float(trs.mean()) if per_frame else 0.0,
        trans_max=float(trs.max()) if per_frame else 0.0,
        add_s_mean=float(adds.mean()) if has_adds else None,
        add_s_max=float(adds.max()) if has_adds else None,
        per_frame=per_frame,
    )


def reference_parity(
    est_poses_path: str,
    ref_poses_path: str,
    model_pts: np.ndarray | None = None,
    **tol,
) -> ParityReport:
    """One-call harness: load both dumps (see `load_pose_dump` for the
    formats), compare."""
    return compare_pose_sequences(
        load_pose_dump(est_poses_path), load_pose_dump(ref_poses_path),
        model_pts, **tol,
    )
