"""Point-to-plane ICP as a batched Gauss-Newton program (counterpart of
ops/icp.py).

`pose` maps MODEL -> CAMERA. Each iteration matches the fixed scene points
to the posed model cloud of every particle, then left-multiplies each pose
by exp(xi) about the weighted scene centroid. The iteration count is fixed
and converged particles freeze, as in the reference. Correspondences come
from `corr_fn` (kernel K1, ops/knn_cuda.make_corr_fn), from `nn_fn` (kernel
K2, make_nn_fn) followed by an indexed gather, or from the dense oracle;
`gn_fn` (kernel K3, make_gn_fn) fuses the search with the gates and the
normal-equation build.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from ..utils import se3
from . import knn


class IcpStats(NamedTuple):
    rmse: torch.Tensor       # [P] weighted point-to-plane RMSE, last iterate
    inliers: torch.Tensor    # [P] sum of correspondence weights
    converged: torch.Tensor  # [P] bool: step norm below threshold at exit
    support: torch.Tensor    # [P] weighted fraction of scene points within
                             # support_tau of the posed model (0 when off),
                             # from the last correspondence search


def correspondence_weights(
    d2: torch.Tensor,
    scene_normals: torch.Tensor,
    model_normals_cam: torch.Tensor,
    scene_weights: torch.Tensor,
    max_corresp_dist: float,
    min_normal_cos: float,
) -> torch.Tensor:
    """Gate correspondences by distance, normal compatibility and padding:
    weights in {0, 1} * scene_weights. The dot products sum left to right,
    as kernel K3 does, so both gate alike."""
    def dot(a, b):
        return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]

    w = scene_weights * (d2 < max_corresp_dist * max_corresp_dist)
    ncos = dot(scene_normals, model_normals_cam)
    have_n = (dot(scene_normals, scene_normals) > 0.5) & (
        dot(model_normals_cam, model_normals_cam) > 0.5
    )
    return w * torch.where(have_n, (ncos > min_normal_cos).to(w.dtype), 1.0)


def cholesky_solve6(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H [...,6,6], g [...,6] with an unrolled 6x6
    Cholesky; the pivot clamp keeps degenerate batches finite."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-20))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = H[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = g[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def solve_gn_step(
    scene_pts: torch.Tensor,    # [...,Ns,3]
    matched_pts: torch.Tensor,  # [...,Ns,3]
    normals: torch.Tensor,      # [...,Ns,3]
    weights: torch.Tensor,      # [...,Ns]
    damping: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One damped Gauss-Newton step of point-to-plane alignment, batched over
    leading axes. Returns (xi [...,6], rmse [...])."""
    r = torch.sum(normals * (scene_pts - matched_pts), dim=-1)     # [...,Ns]
    pxn = torch.linalg.cross(matched_pts, normals)
    J = torch.cat([pxn, normals], dim=-1)                         # [...,Ns,6]
    wJ = J * weights[..., None]
    H = wJ.transpose(-1, -2) @ J                                   # [...,6,6]
    g = (wJ.transpose(-1, -2) @ r[..., None])[..., 0]              # [...,6]
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    lam = damping * (tr / 6.0 + 1e-12)
    H = H + lam[..., None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    xi = cholesky_solve6(H, g)
    wtot = torch.sum(weights, dim=-1)
    rmse = torch.sqrt(torch.sum(weights * r * r, dim=-1) / torch.clamp(wtot, min=1e-9))
    # zero inliers: the system is pure damping, freeze instead
    xi = torch.where((wtot > 6.0)[..., None], xi, 0.0)
    return xi, rmse


def icp_batched(
    poses0: torch.Tensor,         # [P,4,4]
    scene_pts: torch.Tensor,      # [Ns,3] shared observations
    scene_normals: torch.Tensor,  # [Ns,3] (zeros allowed)
    scene_weights: torch.Tensor,  # [Ns]
    model_pts: torch.Tensor,      # [Nm,3] model frame
    model_normals: torch.Tensor,  # [Nm,3] model frame
    *,
    iters: int = 30,
    max_corresp_dist: float = 0.02,
    normal_angle_max_deg: float = 60.0,
    damping: float = 1e-6,
    step_scale: float = 1.0,
    converge_tol: float = 1e-6,
    gn_reps: int = 1,
    nn_fn: Callable | None = None,
    corr_fn: Callable | None = None,
    gn_fn: Callable | None = None,
    support_tau: float = 0.0,
) -> tuple[torch.Tensor, IcpStats]:
    """Batched point-to-plane ICP over the particle axis: each iteration is
    one [P,Ns,Nm] correspondence search plus `gn_reps` GN solves on the same
    matched pairs (re-posed by each increment).

    Correspondences, first given wins:
    - corr_fn(scene [Ns,3], posed [P,Nm,3], posed_normals [P,Nm,3]) ->
      (matched, mnormal, d2, idx);
    - nn_fn(scene [Ns,3], posed [P,Nm,3]) -> (idx, d2), then a gather;
    - default: the dense oracle.
    gn_fn(scene_c, scene_normals, scene_w, posed_c [P,Nm,3], posed_normals)
    -> (H, g, wsum, hits, wrr) replaces all of them with one fused call per
    iteration; it takes gn_reps=1 only, and its baked gates must agree with
    this call's. support_tau > 0 reports IcpStats.support from the last
    search."""
    P = poses0.shape[0]
    min_cos = math.cos(math.radians(normal_angle_max_deg))
    wsum = torch.clamp(torch.sum(scene_weights), min=1e-9)
    anchor = torch.sum(scene_pts * scene_weights[:, None], dim=0) / wsum
    if gn_fn is not None:
        return _icp_fused(poses0, scene_pts - anchor, scene_normals,
                          scene_weights, model_pts, model_normals, anchor, wsum,
                          iters=iters, max_corresp_dist=max_corresp_dist,
                          min_cos=min_cos, damping=damping,
                          step_scale=step_scale, converge_tol=converge_tol,
                          gn_reps=gn_reps, gn_fn=gn_fn, support_tau=support_tau)

    def _support(d2):
        if support_tau <= 0:
            return torch.zeros(d2.shape[:-1], dtype=d2.dtype, device=d2.device)
        hit = (d2 < support_tau * support_tau).to(d2.dtype)
        return torch.sum(hit * scene_weights[None], dim=-1) / wsum

    scene_c = scene_pts - anchor
    poses = poses0
    frozen = torch.zeros((P,), dtype=torch.bool, device=poses0.device)
    rmse = inliers = support = None
    for _ in range(iters):
        posed = se3.transform_points(poses, model_pts)            # [P,Nm,3]
        mnorm_all = se3.rotate_vectors(poses, model_normals)
        if corr_fn is not None:
            matched, mnorm, d2, _ = corr_fn(scene_pts, posed, mnorm_all)
        else:
            if nn_fn is not None:
                idx, d2 = nn_fn(scene_pts, posed)                 # [P,Ns]
            else:
                idx, d2 = knn.nn(scene_pts, posed)
            sel = idx.to(torch.int64)[..., None].expand(-1, -1, 3)
            matched = torch.gather(posed, 1, sel)
            mnorm = torch.gather(mnorm_all, 1, sel)
        w = correspondence_weights(
            d2, scene_normals[None], mnorm, scene_weights[None],
            max_corresp_dist, min_cos,
        )                                                         # [P,Ns]
        m_c = matched - anchor
        nrm = mnorm
        for rep in range(gn_reps):
            xi, rmse = solve_gn_step(scene_c[None], m_c, nrm, w, damping)
            xi = xi * step_scale
            step = torch.sum(xi * xi, dim=-1)
            frozen = frozen | (step < converge_tol * converge_tol)
            xi = torch.where(frozen[:, None], 0.0, xi)
            poses = se3.apply_twist_about(xi, poses, anchor)
            if rep + 1 < gn_reps:
                E = se3.se3_exp(xi)
                m_c = se3.transform_points(E, m_c)
                nrm = se3.rotate_vectors(E, nrm)
        inliers = torch.sum(w, dim=-1)
        support = _support(d2)
    return poses, IcpStats(rmse=rmse, inliers=inliers, converged=frozen,
                           support=support)


def _icp_fused(poses0, scene_c, scene_normals, scene_weights, model_pts,
               model_normals, anchor, wsum, *, iters, max_corresp_dist,
               min_cos, damping, step_scale, converge_tol, gn_reps, gn_fn,
               support_tau) -> tuple[torch.Tensor, IcpStats]:
    """icp_batched's gn_fn path: one fused search + normal-equation build
    and one solve per iteration (the matched points never leave gn_fn)."""
    if gn_reps != 1:
        raise ValueError(
            "gn_fn path runs exactly one linearization per search; "
            f"gn_reps={gn_reps} is not supported (re-linearizing needs "
            "the matched points the fused kernel does not emit).")
    baked = (getattr(gn_fn, "maxd2", None), getattr(gn_fn, "min_cos", None),
             getattr(gn_fn, "tau2", None))
    if baked[0] is not None:
        want = (max_corresp_dist ** 2, min_cos, support_tau ** 2)
        for name, b, w in zip(("maxd2", "min_cos", "tau2"), baked, want):
            if abs(b - w) > 1e-9 * max(1.0, abs(w)):
                raise ValueError(
                    f"gn_fn was built with {name}={b} but icp_batched was "
                    f"called with a value implying {name}={w}; construct "
                    "make_gn_fn with matching gates.")
    poses = poses0
    frozen = torch.zeros((poses0.shape[0],), dtype=torch.bool,
                         device=poses0.device)
    rmse = inliers = support = None
    eye = torch.eye(6, dtype=poses0.dtype, device=poses0.device)
    for _ in range(iters):
        posed_c = se3.transform_points(poses, model_pts) - anchor
        mnorm = se3.rotate_vectors(poses, model_normals)
        H, g, wsum_w, hits, wrr = gn_fn(scene_c, scene_normals, scene_weights,
                                        posed_c, mnorm)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        lam = damping * (tr / 6.0 + 1e-12)
        xi = cholesky_solve6(H + lam[:, None, None] * eye, g) * step_scale
        xi = torch.where((wsum_w > 6.0)[:, None], xi, 0.0)
        step = torch.sum(xi * xi, dim=-1)
        frozen = frozen | (step < converge_tol * converge_tol)
        xi = torch.where(frozen[:, None], 0.0, xi)
        poses = se3.apply_twist_about(xi, poses, anchor)
        rmse = torch.sqrt(wrr / torch.clamp(wsum_w, min=1e-9))
        inliers = wsum_w
        support = hits / wsum
    return poses, IcpStats(rmse=rmse, inliers=inliers, converged=frozen,
                           support=support)


def scene_support(
    poses: torch.Tensor,          # [P,4,4]
    scene_pts: torch.Tensor,      # [Ns,3]
    scene_weights: torch.Tensor,  # [Ns]
    model_pts: torch.Tensor,      # [Nm,3]
    model_normals: torch.Tensor,  # [Nm,3] (only consumed by corr_fn)
    *,
    tau: float,
    nn_fn: Callable | None = None,
    corr_fn: Callable | None = None,
) -> torch.Tensor:
    """Observation-side support: weighted fraction of scene points within
    `tau` of the posed model cloud, per pose ([P])."""
    posed = se3.transform_points(poses, model_pts)
    if corr_fn is not None:
        _, _, d2, _ = corr_fn(scene_pts, posed,
                              se3.rotate_vectors(poses, model_normals))
    elif nn_fn is not None:
        _, d2 = nn_fn(scene_pts, posed)
    else:
        _, d2 = knn.nn(scene_pts, posed)
    hit = (d2 < tau * tau).to(d2.dtype)
    wsum = torch.clamp(torch.sum(scene_weights), min=1e-9)
    return torch.sum(hit * scene_weights[None], dim=-1) / wsum
