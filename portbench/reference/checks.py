"""What decides `correct`: the served poses against the exact ground truth
that the benchmark rendered them from.

The reference answer of every object-frame is its ground-truth pose (the
traffic generator's, in float32): the frames are exact rasters of the
object at that pose, so it is the answer a plain registration would only
approximate. Every served pose of the window is judged, after the window,
by four numbers, each against its cell's limit:

- `adds_mm`: the mean dense ADD-S of every object-frame, each capped at
  the registration limit, in millimetres: the accuracy a user gets, which
  a pose served a frame late (one frame's motion off) already exceeds;
- `lost_share`: the share of object-frames whose pose is non-finite or
  lies at or beyond the registration limit, a dense ADD-S of 10% of the
  object's diameter;
- `rigid_err`: the largest departure of a served pose from a rigid
  transform: max |R^T R - I| and |last row - [0, 0, 0, 1]|, in float64;
- `bad_scores`: the count of served fitness values that are not finite and
  coverages outside [0, 1].

Dense ADD-S (the mean distance from each point of the estimate-posed
cloud to the nearest point of the truth-posed one, 8192 surface samples)
is computed on the device in blocks, by explicit differences in float32 in
the object's frame, so no matrix product (and no TF32) enters it."""
from __future__ import annotations

import numpy as np
import torch

EVAL_POINTS = 8192
EVAL_SEED = 8192
REGISTRATION_LIMIT = 0.10   # ADD-S as a share of the diameter


def dense_cloud(mesh) -> np.ndarray:
    return mesh.sample_surface(EVAL_POINTS, seed=EVAL_SEED)[0]


def add_s(est: np.ndarray, gt: np.ndarray, cloud: np.ndarray, device,
          block: int = 1024) -> np.ndarray:
    """Dense ADD-S (metres) of poses est [M,4,4] against gt [M,4,4] over
    one object's cloud [N,3]; +inf where a pose is not finite."""
    out = np.full(len(est), np.inf)
    ok = np.isfinite(est).all(axis=(1, 2))
    if not ok.any():
        return out
    pts = torch.as_tensor(cloud, dtype=torch.float32, device=device)
    E = torch.as_tensor(est[ok], dtype=torch.float64, device=device)
    G = torch.as_tensor(gt[ok], dtype=torch.float64, device=device)
    # the estimate-posed cloud in the truth's model frame: G^-1 E p
    rel = torch.linalg.solve(G, E).to(torch.float32)           # [M,4,4]
    R, t = rel[:, :3, :3], rel[:, :3, 3]
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    moved = torch.stack([R[:, i, 0, None] * x + R[:, i, 1, None] * y
                         + R[:, i, 2, None] * z + t[:, i, None] for i in range(3)],
                        dim=-1)                                  # [M,N,3]
    dist = torch.empty(moved.shape[:2], dtype=torch.float32, device=device)
    for m in range(moved.shape[0]):
        for s in range(0, moved.shape[1], block):
            a = moved[m, s:s + block]
            d2 = ((a[:, None, 0] - x) ** 2 + (a[:, None, 1] - y) ** 2
                  + (a[:, None, 2] - z) ** 2)
            dist[m, s:s + block] = torch.sqrt(torch.amin(d2, dim=1))
    out[ok] = dist.mean(dim=1).double().cpu().numpy()
    return out


def rigid_err(poses: np.ndarray) -> float:
    P = np.asarray(poses, np.float64).reshape(-1, 4, 4)
    if not np.isfinite(P).all():
        return float("inf")
    R = P[:, :3, :3]
    ortho = np.abs(np.swapaxes(R, 1, 2) @ R - np.eye(3)).max()
    bottom = np.abs(P[:, 3] - np.array([0.0, 0.0, 0.0, 1.0])).max()
    return float(max(ortho, bottom))


def judge(poses, gt, objects, fitness, coverage, meshes, device) -> dict:
    """The numbers compared, and the errors behind the end-to-end metric:
    poses and gt [M,4,4] host arrays, objects [M] the object index of each,
    fitness and coverage [M]."""
    poses, gt, objects = np.asarray(poses), np.asarray(gt), np.asarray(objects)
    err = np.full(len(poses), np.inf)
    diam = np.zeros(len(poses))
    for o, mesh in enumerate(meshes):
        sel = objects == o
        if sel.any():
            err[sel] = add_s(poses[sel], gt[sel], dense_cloud(mesh), device)
            diam[sel] = mesh.diameter()
    limit = REGISTRATION_LIMIT * diam
    fitness, coverage = np.asarray(fitness, np.float64), np.asarray(coverage, np.float64)
    bad = (~np.isfinite(fitness)) | ~((coverage >= 0.0) & (coverage <= 1.0))
    capped = np.minimum(err, limit)
    return {
        "compared": {
            "adds_mm": 1e3 * float(np.mean(capped)) if len(err) else float("inf"),
            "lost_share": float(np.mean(~(err < limit))) if len(err) else 1.0,
            "rigid_err": rigid_err(poses) if len(poses) else float("inf"),
            "bad_scores": float(np.sum(bad)),
        },
        "adds_capped_m": capped,
    }
