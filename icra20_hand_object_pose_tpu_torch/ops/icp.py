"""Point-to-plane ICP as a batched Gauss-Newton program (counterpart of
ops/icp.py).

`pose` maps MODEL -> CAMERA. Each iteration matches the fixed scene points
to the posed model cloud of every particle, then left-multiplies each pose
by exp(xi) about the weighted scene centroid. The iteration count is fixed
and converged particles freeze, as in the reference. Correspondences come
from `corr_fn` (kernel K1, ops/knn_cuda.make_corr_fn, which takes the poses
and the model cloud and poses it itself), from `nn_fn` (kernel K2,
make_nn_fn) on clouds posed here, followed by an indexed gather, or from
the dense oracle;
`gn_fn` (kernel K3, make_gn_fn) fuses the search with the gates and the
normal-equation build. Everything between one search and the next (the
gates, the `gn_reps` solves, the pose updates) is `gn_iterate_plain`, which
kernel K4 (ops/knn_cuda.gn_iterate_batched) runs in one launch on the card.
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


def cholesky_solve6(H: torch.Tensor, g: torch.Tensor,
                    floor: torch.Tensor) -> torch.Tensor:
    """Solve H x = g for SPD H [...,6,6], g [...,6] with an unrolled 6x6
    Cholesky. A pivot at or below 1e-20 becomes `floor` [...]: the damping
    that was added to H's diagonal, below which no pivot of the damped
    system falls in exact arithmetic. FP32 rounding can leave a nearly
    singular system indefinite; the reference's clamp of such a pivot to
    1e-20 overflows the solve into inf - inf = NaN."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.where(s > 1e-20, s, floor))
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
    Jr = torch.cat([pxn, normals, r[..., None]], dim=-1)          # [...,Ns,7]: [J | r]
    wJ = Jr[..., :6] * weights[..., None]
    # H and g from one batched product [6,Ns] x [Ns,7]: a separate
    # matrix-vector product for g runs a kernel that cuBLAS picks by the
    # batch count, which gave a particle other bits in a library of another
    # size (or on a mesh rank with a share of it); this one does not
    Hg = wJ.transpose(-1, -2) @ Jr                                 # [...,6,7]
    H, g = Hg[..., :6], Hg[..., 6]
    tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
    lam = damping * (tr / 6.0 + 1e-12)
    H = H + lam[..., None, None] * torch.eye(6, dtype=H.dtype, device=H.device)
    xi = cholesky_solve6(H, g, lam)
    wtot = torch.sum(weights, dim=-1)
    rmse = torch.sqrt(torch.sum(weights * r * r, dim=-1) / torch.clamp(wtot, min=1e-9))
    # zero inliers: the system is pure damping, freeze instead
    xi = torch.where((wtot > 6.0)[..., None], xi, 0.0)
    return xi, rmse


def gn_iterate_plain(
    poses: torch.Tensor,          # [O,P,4,4]
    frozen: torch.Tensor,         # [O,P] bool
    matched: torch.Tensor,        # [O,P,Ns,3] matched model points (camera)
    mnorm: torch.Tensor,          # [O,P,Ns,3] their normals
    d2: torch.Tensor,             # [O,P,Ns] squared match distances
    scene_c: torch.Tensor,        # [O,Ns,3] scene points less the anchor
    scene_normals: torch.Tensor,  # [1|O,Ns,3]
    scene_weights: torch.Tensor,  # [O,Ns]
    anchor: torch.Tensor,         # [O,3] weighted scene centroid
    wsum: torch.Tensor,           # [O] clamped scene weight sum
    *,
    max_corresp_dist: float,
    min_cos: float,
    damping: float,
    step_scale: float,
    converge_tol: float,
    gn_reps: int,
    support_tau: float,
) -> tuple[torch.Tensor, IcpStats]:
    """What one ICP iteration does after its correspondence search: the
    gates, then `gn_reps` damped Gauss-Newton solves on the matched pairs,
    each re-posed by the increment before the next. Returns (poses, stats),
    `stats.converged` the updated freeze. The plain version of kernel K4
    (ops/knn_cuda.gn_iterate_batched), which runs it in one launch."""
    w = correspondence_weights(
        d2, scene_normals[:, None], mnorm, scene_weights[:, None],
        max_corresp_dist, min_cos,
    )                                                         # [O,P,Ns]
    m_c = matched - anchor[:, None, None]
    nrm = mnorm
    rmse = None
    for rep in range(gn_reps):
        xi, rmse = solve_gn_step(scene_c[:, None], m_c, nrm, w, damping)
        xi = xi * step_scale
        step = torch.sum(xi * xi, dim=-1)
        frozen = frozen | (step < converge_tol * converge_tol)
        xi = torch.where(frozen[..., None], 0.0, xi)
        poses = se3.apply_twist_about(xi, poses, anchor[:, None])
        if rep + 1 < gn_reps:
            E = se3.se3_exp(xi)
            m_c = se3.transform_points(E, m_c)
            nrm = se3.rotate_vectors(E, nrm)
    if support_tau <= 0:
        support = torch.zeros(d2.shape[:-1], dtype=d2.dtype, device=d2.device)
    else:
        hit = (d2 < support_tau * support_tau).to(d2.dtype)
        support = torch.sum(hit * scene_weights[:, None], dim=-1) / wsum[:, None]
    return poses, IcpStats(rmse=rmse, inliers=torch.sum(w, dim=-1),
                           converged=frozen, support=support)


def _lift(poses: torch.Tensor, *tensors: torch.Tensor):
    """The single-object arguments of icp_batched / scene_support with a
    leading object axis of length 1: (lifted?, poses, tensors...)."""
    if poses.dim() == 4:
        return (True, poses) + tensors
    return (False, poses[None]) + tuple(t[None] for t in tensors)


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

    A library of O objects runs as one program: poses0 [O,P,4,4], scene
    points and normals [O,Ns,3] (or [1,Ns,3]: one scene shared by all),
    scene_weights [O,Ns], model clouds [O,Nm,3]. The anchor, the weight sum
    and the freeze of a particle are per object; the outputs keep [O,P].

    Correspondences, first given wins; each callback is handed the library
    form (O = 1 for a single object) and returns tensors on [O,P] axes:
    - corr_fn(scene [1|O,Ns,3], poses [O,P,4,4], model_pts [O,Nm,3],
      model_normals [O,Nm,3]) -> (matched, mnormal, d2, idx), the model
      posed by each pose;
    - nn_fn(scene [1|O,Ns,3], posed [O,P,Nm,3]) -> (idx, d2), then a gather;
    - default: the dense oracle.
    gn_fn(scene_c [O,Ns,3], scene_normals, scene_w [O,Ns], posed_c
    [O,P,Nm,3], posed_normals) -> (H, g, wsum, hits, wrr) replaces all of
    them with one fused call per iteration; it takes gn_reps=1 only, and
    its baked gates must agree with this call's. support_tau > 0 reports
    IcpStats.support from the last search."""
    lifted, poses0, scene_pts, scene_normals, scene_weights, model_pts, model_normals = _lift(
        poses0, scene_pts, scene_normals, scene_weights, model_pts, model_normals)
    poses, stats = _icp_objects(
        poses0, scene_pts, scene_normals, scene_weights, model_pts, model_normals,
        iters=iters, max_corresp_dist=max_corresp_dist,
        normal_angle_max_deg=normal_angle_max_deg, damping=damping,
        step_scale=step_scale, converge_tol=converge_tol, gn_reps=gn_reps,
        nn_fn=nn_fn, corr_fn=corr_fn, gn_fn=gn_fn, support_tau=support_tau)
    if lifted:
        return poses, stats
    return poses[0], IcpStats(*(a[0] for a in stats))


def _search(scene_pts, poses, model_pts, model_normals, nn_fn, corr_fn):
    """(matched, mnormal, d2) of scene [1|O,Ns,3] in the model [O,Nm,3]
    posed by poses [O,P,4,4]: corr_fn poses it itself, the others search
    it posed here."""
    if corr_fn is not None:
        matched, mnorm, d2, _ = corr_fn(scene_pts, poses, model_pts, model_normals)
        return matched, mnorm, d2
    posed = se3.transform_points(poses, model_pts[:, None])      # [O,P,Nm,3]
    mnorm_all = se3.rotate_vectors(poses, model_normals[:, None])
    if nn_fn is not None:
        idx, d2 = nn_fn(scene_pts, posed)                         # [O,P,Ns]
    else:
        idx, d2 = knn.nn(scene_pts[:, None], posed)
    sel = idx.to(torch.int64)[..., None].expand(idx.shape + (3,))
    return torch.gather(posed, 2, sel), torch.gather(mnorm_all, 2, sel), d2


def weighted_sum(pts: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[O,3]: sum over n of weights[o,n] * pts[o,n] (pts [1|O,Ns,3], one
    cloud for all objects or one each), one reduction per object. A CUDA
    reduction's summation order follows how many outputs it has, so a sum
    over all O at once would give an object other bits in a library of
    another size (or on a mesh rank with O/n of them)."""
    return torch.stack([torch.sum(pts[min(o, pts.shape[0] - 1)] * w[:, None], dim=0)
                        for o, w in enumerate(weights)])


def _icp_objects(poses0, scene_pts, scene_normals, scene_weights, model_pts,
                 model_normals, *, iters, max_corresp_dist,
                 normal_angle_max_deg, damping, step_scale, converge_tol,
                 gn_reps, nn_fn, corr_fn, gn_fn, support_tau):
    """icp_batched on its library form: poses0 [O,P,4,4], scene [1|O,Ns,..],
    scene_weights [O,Ns], model [O,Nm,3]."""
    min_cos = math.cos(math.radians(normal_angle_max_deg))
    wsum = torch.clamp(torch.sum(scene_weights, dim=-1), min=1e-9)       # [O]
    anchor = weighted_sum(scene_pts, scene_weights) / wsum[:, None]
    scene_c = scene_pts - anchor[:, None]                               # [O,Ns,3]
    if gn_fn is not None:
        return _icp_fused(poses0, scene_c, scene_normals,
                          scene_weights, model_pts, model_normals, anchor, wsum,
                          iters=iters, max_corresp_dist=max_corresp_dist,
                          min_cos=min_cos, damping=damping,
                          step_scale=step_scale, converge_tol=converge_tol,
                          gn_reps=gn_reps, gn_fn=gn_fn, support_tau=support_tau)

    # the Gauss-Newton tail of each iteration: kernel K4 on the card, the
    # plain version on the CPU (imported here: ops/knn_cuda.py imports this
    # module)
    from .knn_cuda import gn_iterate_batched

    poses = poses0
    frozen = torch.zeros(poses0.shape[:2], dtype=torch.bool, device=poses0.device)
    stats = IcpStats(rmse=None, inliers=None, converged=frozen, support=None)
    for _ in range(iters):
        matched, mnorm, d2 = _search(scene_pts, poses, model_pts, model_normals, nn_fn,
                                     corr_fn)
        poses, stats = gn_iterate_batched(
            poses, stats.converged, matched, mnorm, d2, scene_c, scene_normals,
            scene_weights, anchor, wsum, max_corresp_dist=max_corresp_dist,
            min_cos=min_cos, damping=damping, step_scale=step_scale,
            converge_tol=converge_tol, gn_reps=gn_reps, support_tau=support_tau)
    return poses, stats


def _icp_fused(poses0, scene_c, scene_normals, scene_weights, model_pts,
               model_normals, anchor, wsum, *, iters, max_corresp_dist,
               min_cos, damping, step_scale, converge_tol, gn_reps, gn_fn,
               support_tau) -> tuple[torch.Tensor, IcpStats]:
    """_icp_objects' gn_fn path: one fused search + normal-equation build
    and one solve per iteration (the matched points never leave gn_fn).
    scene_c [O,Ns,3] is anchored per object (anchor [O,3], wsum [O])."""
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
    O = poses0.shape[0]
    scene_normals = scene_normals.expand((O,) + tuple(scene_normals.shape[1:]))
    poses = poses0
    frozen = torch.zeros(poses0.shape[:2], dtype=torch.bool,
                         device=poses0.device)
    rmse = inliers = support = None
    eye = torch.eye(6, dtype=poses0.dtype, device=poses0.device)
    for _ in range(iters):
        posed_c = se3.transform_points(poses, model_pts[:, None]) - anchor[:, None, None]
        mnorm = se3.rotate_vectors(poses, model_normals[:, None])
        H, g, wsum_w, hits, wrr = gn_fn(scene_c, scene_normals, scene_weights,
                                        posed_c, mnorm)
        tr = torch.diagonal(H, dim1=-2, dim2=-1).sum(-1)
        lam = damping * (tr / 6.0 + 1e-12)
        xi = cholesky_solve6(H + lam[..., None, None] * eye, g, lam) * step_scale
        xi = torch.where((wsum_w > 6.0)[..., None], xi, 0.0)
        step = torch.sum(xi * xi, dim=-1)
        frozen = frozen | (step < converge_tol * converge_tol)
        xi = torch.where(frozen[..., None], 0.0, xi)
        poses = se3.apply_twist_about(xi, poses, anchor[:, None])
        rmse = torch.sqrt(wrr / torch.clamp(wsum_w, min=1e-9))
        inliers = wsum_w
        support = hits / wsum[:, None]
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
    `tau` of the posed model cloud, per pose ([P]). For a library: poses
    [O,P,4,4], scene [1|O,Ns,3], weights [O,Ns], model [O,Nm,3] -> [O,P]."""
    lifted, poses, scene_pts, scene_weights, model_pts, model_normals = _lift(
        poses, scene_pts, scene_weights, model_pts, model_normals)
    if corr_fn is not None:
        _, _, d2, _ = corr_fn(scene_pts, poses, model_pts, model_normals)
    else:
        posed = se3.transform_points(poses, model_pts[:, None])
        _, d2 = (nn_fn(scene_pts, posed) if nn_fn is not None
                 else knn.nn(scene_pts[:, None], posed))
    hit = (d2 < tau * tau).to(d2.dtype)
    wsum = torch.clamp(torch.sum(scene_weights, dim=-1), min=1e-9)
    out = torch.sum(hit * scene_weights[:, None], dim=-1) / wsum[:, None]
    return out if lifted else out[0]


def icp(
    pose0: torch.Tensor,          # [4,4] model->camera initial pose
    scene_pts: torch.Tensor,
    scene_normals: torch.Tensor,
    scene_weights: torch.Tensor,
    model_pts: torch.Tensor,
    model_normals: torch.Tensor,
    **kwargs,
) -> tuple[torch.Tensor, IcpStats]:
    """Single-hypothesis point-to-plane ICP: the P=1 slice of
    `icp_batched`."""
    poses, stats = icp_batched(
        pose0[None], scene_pts, scene_normals, scene_weights,
        model_pts, model_normals, **kwargs,
    )
    return poses[0], IcpStats(*(a[0] for a in stats))
