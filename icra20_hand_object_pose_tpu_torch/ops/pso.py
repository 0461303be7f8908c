"""Particle-swarm pose search with in-loop batched ICP (counterpart of
ops/pso.py).

The reference's `lax.scan`s are Python loops here and its `lax.cond`s
Python branches; the swarm is a [P,4,4] tensor. Per iteration: perturb,
in-scan ICP on fixed-size subsets, projective scoring plus the
scene-support term, global best, elite resample. After the scan: explorer
pulls, axial slides, the full-cloud ICP polish, fine-tier scoring and the
score-only finisher. Every perturbation draws from `gen` (a
torch.Generator or injected draws). With `gn_fn` (kernel K3) the in-scan
refine and the explorer pulls run the fused search + normal-equation
path; the polish keeps `corr_fn`/`nn_fn`. Sharding (`axis_name`) and
pixel-mode scoring are not ported yet.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import torch

from ..utils import se3
from ..utils.config import IcpConfig, PsoConfig, ScoreConfig
from . import icp as icp_mod
from . import score


class PsoResult(NamedTuple):
    best_pose: torch.Tensor      # [4,4]
    best_fitness: torch.Tensor   # scalar
    best_coverage: torch.Tensor  # scalar
    poses: torch.Tensor          # [P,4,4] final swarm
    fitness: torch.Tensor        # [P]
    fitness_trace: torch.Tensor  # [iters] best fitness per iteration
    cand_poses: torch.Tensor     # [C,4,4] fine-tier polished candidates
    cand_fitness: torch.Tensor   # [C]
    cand_coverage: torch.Tensor  # [C]


def top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest entries of a 1-D tensor, largest first, ties
    to the lower index (the order `jax.lax.top_k` guarantees and
    `torch.topk` does not)."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def score_particles(
    poses: torch.Tensor,           # [P,4,4]
    render_pts: torch.Tensor,      # [Nr,3]
    render_normals: torch.Tensor,  # [Nr,3]
    render_w: torch.Tensor,        # [Nr]
    observed_depth: torch.Tensor,  # [h,w]
    observed_valid: torch.Tensor,  # [h,w]
    hand_depth: torch.Tensor,      # [h,w] +inf = no hand
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    splat_radius: int,
    score_cfg: ScoreConfig,
    subpixel: bool = False,
    observed_enc: torch.Tensor | None = None,
    mxu_tables: tuple | None = None,
    sample_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Point-mode render-and-compare fitness for every particle:
    (fitness [P], coverage [P])."""
    if score_cfg.mode != "point":
        raise NotImplementedError(
            f"score mode {score_cfg.mode!r} is not ported yet (point only)")
    pts_cam = se3.transform_points(poses, render_pts)
    nrm_cam = se3.rotate_vectors(poses, render_normals)
    terms = score.compare_points(
        pts_cam, nrm_cam, observed_depth, observed_valid, hand_depth,
        fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
        depth_tau=score_cfg.depth_tau,
        wrong_side_penalty=score_cfg.wrong_side_penalty,
        occlusion_margin=score_cfg.occlusion_margin,
        invalid_penalty=score_cfg.invalid_penalty,
        subpixel=subpixel,
        ghost_dilate=score_cfg.ghost_dilate,
        observed_enc=observed_enc,
        mxu_tables=mxu_tables,
        neutral_cov_exempt=score_cfg.neutral_cov_exempt,
        sample_mask=sample_mask,
        mask_count_floor=score_cfg.self_occ_count_floor,
    )
    return terms.fitness + score_cfg.coverage_weight * terms.coverage, terms.coverage


def _mean_displacement(poses: torch.Tensor, prior_pose: torch.Tensor,
                       model_pts: torch.Tensor) -> torch.Tensor:
    """[C] mean point-to-point displacement of a 128-point model subset
    between each pose and the prior."""
    sub = model_pts[: min(128, model_pts.shape[0])]
    pa = se3.transform_points(poses, sub)
    pb = se3.transform_points(prior_pose, sub)
    return torch.mean(torch.linalg.norm(pa - pb[None], dim=-1), dim=-1)


def continuity_select(cand_poses, cand_fitness, prior_pose, model_pts, *,
                      eps: float) -> torch.Tensor:
    """Among candidates within eps*|best| of the top fitness, the index of
    the one closest to the prior pose (PsoConfig.tie_break_eps)."""
    d_prior = _mean_displacement(cand_poses, prior_pose, model_pts)
    fmax = torch.max(cand_fitness)
    elig = cand_fitness >= fmax - eps * torch.abs(fmax)
    return torch.argmin(torch.where(elig, d_prior, float("inf")))


def snap_to_branch(
    pose: torch.Tensor,        # [4,4] selected best pose
    prior_pose: torch.Tensor,  # [4,4]
    symmetries: torch.Tensor,  # [S,4,4] symmetry group incl. identity
    model_pts: torch.Tensor,   # [Nm,3]
) -> torch.Tensor:
    """pose @ S* for the symmetry S* whose branch lies closest to the prior
    (an exact twin renders the same depth, so the branch is convention)."""
    cands = pose[None] @ symmetries
    return cands[torch.argmin(_mean_displacement(cands, prior_pose, model_pts))]


def pso(
    gen,
    poses0: torch.Tensor,          # [P,4,4] initial swarm
    scene_pts: torch.Tensor,       # [Ns,3]
    scene_normals: torch.Tensor,   # [Ns,3]
    scene_weights: torch.Tensor,   # [Ns]
    model_pts: torch.Tensor,       # [Nm,3]
    model_normals: torch.Tensor,   # [Nm,3]
    render_pts: torch.Tensor,      # [Nr,3]
    render_normals: torch.Tensor,  # [Nr,3]
    render_w: torch.Tensor,        # [Nr]
    observed_depth: torch.Tensor,  # [h,w]
    observed_valid: torch.Tensor,  # [h,w]
    hand_depth: torch.Tensor,      # [h,w]
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    splat_radius: int = 1,
    pso_cfg: PsoConfig = PsoConfig(),
    icp_cfg: IcpConfig = IcpConfig(),
    score_cfg: ScoreConfig = ScoreConfig(),
    nn_fn=None,
    corr_fn=None,
    gn_fn=None,
    observed_neutral: torch.Tensor | None = None,
    observed_hi: tuple | None = None,
    render_vis: torch.Tensor | None = None,
    prior_pose: torch.Tensor | None = None,
    prior_valid: bool = True,
    explorer_seeds: torch.Tensor | None = None,
) -> PsoResult:
    """Annealed swarm search over SE(3) with in-loop batched ICP refine.

    observed_hi = (depth, valid, neutral, hand_depth, fx, fy, cx, cy, h, w)
    is the full-resolution scoring tier of the polish and finisher;
    render_vis [Nr] the frame-constant self-occlusion sample mask;
    explorer_seeds [E,4,4] global seeds refined outside the swarm."""
    P = poses0.shape[0]
    dev = poses0.device
    n_resample = max(1, int(round(P * pso_cfg.elite_frac))) if P > 1 else 0

    kr = min(pso_cfg.scan_render_subset, render_pts.shape[0])
    enc_lo = score.encode_observed(
        observed_depth, observed_valid, score_cfg.ghost_dilate,
        neutral=observed_neutral,
    )
    use_mxu = score_cfg.gather_mode == "mxu" and score_cfg.mode == "point"
    mxu_lo = ("image", enc_lo, score.hand_table(hand_depth)) if use_mxu else None
    score_fn = partial(
        score_particles,
        render_pts=render_pts[:kr], render_normals=render_normals[:kr],
        render_w=render_w[:kr],
        observed_depth=observed_depth, observed_valid=observed_valid,
        hand_depth=hand_depth,
        fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
        splat_radius=splat_radius, score_cfg=score_cfg,
        observed_enc=enc_lo, mxu_tables=mxu_lo,
        sample_mask=None if render_vis is None else render_vis[:kr],
    )
    if observed_hi is not None:
        (d_hi, v_hi, n_hi, h_hi, fx_h, fy_h, cx_h, cy_h, hh, wh) = observed_hi
        enc_hi = score.encode_observed(d_hi, v_hi, score_cfg.ghost_dilate,
                                       neutral=n_hi)
        score_cfg_hi = (
            dataclasses.replace(score_cfg, depth_tau=score_cfg.depth_tau_fine)
            if score_cfg.depth_tau_fine > 0 else score_cfg
        )
        score_fn_hi = partial(
            score_particles,
            render_pts=render_pts, render_normals=render_normals,
            render_w=render_w,
            observed_depth=d_hi, observed_valid=v_hi, hand_depth=h_hi,
            fx=fx_h, fy=fy_h, cx=cx_h, cy=cy_h, height=hh, width=wh,
            splat_radius=splat_radius, score_cfg=score_cfg_hi,
            subpixel=score_cfg.subpixel,
            observed_enc=enc_hi,
            sample_mask=render_vis,
        )
    else:
        score_fn_hi = score_fn
        score_cfg_hi = score_cfg

    ks = min(pso_cfg.icp_scene_subset, scene_pts.shape[0])
    km = min(pso_cfg.icp_model_subset, model_pts.shape[0])
    cov_w = float(score_cfg.scene_cov_weight)
    cov_tau = float(score_cfg.scene_cov_tau)
    use_cov = cov_w > 0.0

    def refine(poses):
        refined, st = icp_mod.icp_batched(
            poses, scene_pts[:ks], scene_normals[:ks], scene_weights[:ks],
            model_pts[:km], model_normals[:km],
            iters=pso_cfg.icp_iters_inner,
            max_corresp_dist=icp_cfg.max_corresp_dist,
            normal_angle_max_deg=icp_cfg.normal_angle_max_deg,
            damping=icp_cfg.damping,
            step_scale=icp_cfg.step_scale,
            # the fused kernel runs one linearization per search
            gn_reps=1 if gn_fn is not None else icp_cfg.gn_reps,
            nn_fn=nn_fn, corr_fn=corr_fn, gn_fn=gn_fn,
            support_tau=cov_tau if use_cov else 0.0,
        )
        return refined, st.support

    def sub_support(poses):
        return icp_mod.scene_support(
            poses, scene_pts[:ks], scene_weights[:ks],
            model_pts[:km], model_normals[:km],
            tau=cov_tau, nn_fn=nn_fn, corr_fn=corr_fn,
        )

    def swarm_best(poses, fitness, coverage):
        bi = torch.argmax(fitness)
        return poses[bi], fitness[bi], coverage[bi]

    fitness, coverage = score_fn(poses0)
    if use_cov:
        supp = sub_support(poses0)
        fitness = fitness + cov_w * (supp - 1.0)
    else:
        supp = torch.zeros((P,), dtype=poses0.dtype, device=dev)
    poses = poses0
    best_pose, best_fit, best_cov = swarm_best(poses0, fitness, coverage)
    sig = 1.0
    trace = []
    for it in range(pso_cfg.iters):
        # 1. perturb; particle 0 pinned to the incumbent best (elitism)
        poses = se3.perturb_pose(
            gen, poses, pso_cfg.rot_sigma * sig, pso_cfg.trans_sigma * sig,
            shape=(P,),
        )
        poses[0] = best_pose
        # 2. ICP refine every icp_every iterations (support rides along)
        if pso_cfg.icp_every > 0:
            if it % pso_cfg.icp_every == 0:
                poses, supp = refine(poses)
        elif use_cov:
            supp = sub_support(poses)
        # 3. render-and-compare fitness for the whole swarm
        fitness, coverage = score_fn(poses)
        if use_cov:
            fitness = fitness + cov_w * (supp - 1.0)
        # 4. global best update
        bp, bf, bc = swarm_best(poses, fitness, coverage)
        improved = bf > best_fit
        best_pose = torch.where(improved, bp, best_pose)
        best_fit = torch.where(improved, bf, best_fit)
        best_cov = torch.where(improved, bc, best_cov)
        # 5. elite resample: the worst particles teleport near the best
        if n_resample > 0:
            worst = top_k(-fitness, n_resample)
            fresh = se3.perturb_pose(
                gen, best_pose,
                pso_cfg.rot_sigma * sig, pso_cfg.trans_sigma * sig,
                shape=(n_resample,),
            )
            if it >= pso_cfg.resample_after:
                poses = poses.clone()
                poses[worst] = fresh
                fitness = fitness.clone()
                fitness[worst] = -float("inf")
        sig = sig * pso_cfg.sigma_decay
        trace.append(best_fit)
    trace = torch.stack(trace) if trace else torch.zeros((0,), device=dev)

    # Final polish at the FINE tier over the top-K swarm candidates, plus
    # the best explorer seed and the axial-slide proposals.
    K = max(0, min(pso_cfg.polish_top_k, P - 1))
    if K > 0:
        topi = top_k(fitness, K)
        cands = torch.cat([best_pose[None], poses[topi]])
    else:
        cands = best_pose[None]
    if explorer_seeds is not None:
        refined_seeds, supp_exp = refine(explorer_seeds)
        for _ in range(2):                      # seeds start far out
            refined_seeds, supp_exp = refine(refined_seeds)
        f_exp, _ = score_fn(refined_seeds)
        if use_cov:
            f_exp = f_exp + cov_w * (supp_exp - 1.0)
        cands = torch.cat([cands, refined_seeds[torch.argmax(f_exp)][None]])
    n_slide = pso_cfg.slide_proposals
    if n_slide > 1:
        mc = torch.mean(model_pts, dim=0)
        Xc = model_pts - mc
        _, evecs = torch.linalg.eigh(Xc.T @ Xc)
        ax = evecs[:, -1]                                  # model frame
        proj = Xc @ ax
        extent = torch.max(proj) - torch.min(proj)
        half = n_slide // 2
        fr = (torch.arange(1, half + 1, dtype=poses0.dtype, device=dev) / half
              * pso_cfg.slide_max_frac)
        offs = torch.cat([fr, -fr]) * extent              # [2*half]
        d_cam = best_pose[:3, :3] @ ax                     # camera frame
        slid = best_pose[None].repeat(offs.shape[0], 1, 1)
        slid[:, :3, 3] += offs[:, None] * d_cam[None]
        cands = torch.cat([cands, slid])
    polished, pol_stats = icp_mod.icp_batched(
        cands, scene_pts, scene_normals, scene_weights,
        model_pts, model_normals,
        iters=icp_cfg.iters,
        max_corresp_dist=icp_cfg.max_corresp_dist,
        normal_angle_max_deg=icp_cfg.normal_angle_max_deg,
        damping=icp_cfg.damping,
        step_scale=icp_cfg.step_scale,
        gn_reps=icp_cfg.gn_reps,
        nn_fn=nn_fn, corr_fn=corr_fn,
        support_tau=cov_tau if use_cov else 0.0,
    )
    f_c, c_c = score_fn_hi(cands)
    f_p, c_p = score_fn_hi(polished)
    if use_cov:
        supp_c = icp_mod.scene_support(
            cands, scene_pts, scene_weights, model_pts, model_normals,
            tau=cov_tau, nn_fn=nn_fn, corr_fn=corr_fn,
        )
        f_c = f_c + cov_w * (supp_c - 1.0)
        f_p = f_p + cov_w * (pol_stats.support - 1.0)
    take_pol = f_p >= f_c - pso_cfg.polish_accept_tol
    f_sel = torch.where(take_pol, f_p, f_c)
    c_sel = torch.where(take_pol, c_p, c_c)
    p_sel = torch.where(take_pol[:, None, None], polished, cands)
    s_sel = (torch.where(take_pol, pol_stats.support, supp_c) if use_cov
             else torch.zeros_like(f_sel))
    bi = torch.argmax(f_sel)
    if prior_pose is not None and pso_cfg.tie_break_eps > 0 and prior_valid:
        bi = continuity_select(p_sel, f_sel, prior_pose, model_pts,
                               eps=pso_cfg.tie_break_eps)
    best_pose, best_fit, best_cov = p_sel[bi], f_sel[bi], c_sel[bi]
    term0 = cov_w * (s_sel[bi] - 1.0) if use_cov else 0.0

    # Score-only annealed finisher around the selected best (no ICP).
    if pso_cfg.finish_iters > 0:
        fs0 = pso_cfg.finish_sigma_frac
        Pf = max(2, min(pso_cfg.finish_particles, 4 * P))
        score_fn_fin = score_fn_hi
        if use_mxu and observed_hi is not None:
            # per-sample patches around the reference projections: a
            # finisher candidate reads 0.0 outside its sample's patch
            S = pso_cfg.finish_patch
            ref = se3.transform_points(best_pose, render_pts)     # [Nr,3]
            zr = torch.clamp(ref[..., 2], min=1e-6)
            ur = torch.round(ref[..., 0] / zr * fx_h + cx_h).to(torch.int64)
            vr = torch.round(ref[..., 1] / zr * fy_h + cy_h).to(torch.int64)
            pu0 = torch.clamp(ur - S // 2, 0, wh - S)
            pv0 = torch.clamp(vr - S // 2, 0, hh - S)
            mxu_fin = ("patch", enc_hi, score.hand_table(h_hi), pv0, pu0, S)
            score_fn_fin = partial(score_fn_hi, mxu_tables=mxu_fin)
        R = max(1, pso_cfg.finish_sigma_rungs)
        ladder = torch.pow(
            torch.tensor(pso_cfg.sigma_decay, dtype=poses0.dtype, device=dev),
            torch.arange(Pf, dtype=poses0.dtype, device=dev) % R,
        )[:, None]
        iter_decay = pso_cfg.sigma_decay ** R
        sig = 1.0
        for _ in range(pso_cfg.finish_iters):
            cand = se3.perturb_pose(
                gen, best_pose,
                pso_cfg.rot_sigma * fs0 * sig * ladder,
                pso_cfg.trans_sigma * fs0 * sig * ladder,
                shape=(Pf,),
            )
            cand[0] = best_pose
            f, c = score_fn_fin(cand)
            f = f + term0
            bp, bf, bc = swarm_best(cand, f, c)
            improved = bf > best_fit
            best_pose = torch.where(improved, bp, best_pose)
            best_fit = torch.where(improved, bf, best_fit)
            best_cov = torch.where(improved, bc, best_cov)
            sig = sig * iter_decay

    return PsoResult(
        best_pose=best_pose, best_fitness=best_fit, best_coverage=best_cov,
        poses=poses, fitness=fitness, fitness_trace=trace,
        cand_poses=p_sel, cand_fitness=f_sel, cand_coverage=c_sel,
    )


def diverse_hypotheses(
    cand_poses: torch.Tensor,     # [C,4,4]
    cand_fitness: torch.Tensor,   # [C]
    n: int,
    *,
    first_pose: torch.Tensor | None = None,
    first_fitness: torch.Tensor | None = None,
    rot_min_deg: float = 15.0,
    trans_min: float = 0.02,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Greedy farthest-basin selection of n hypotheses, each at least
    (rot_min_deg OR trans_min) from all earlier picks; slots without a
    distinct basin get fitness -inf."""
    sel_p, sel_f = [], []
    avail = cand_fitness
    neg_inf = torch.full_like(cand_fitness, -float("inf"))
    if first_pose is not None:
        sel_p.append(first_pose)
        sel_f.append(first_fitness if first_fitness is not None
                     else cand_fitness.max())
        avail = torch.where(_near_pose(cand_poses, first_pose, rot_min_deg,
                                       trans_min), neg_inf, avail)
    while len(sel_p) < n:
        i = torch.argmax(avail)
        p = cand_poses[i]
        sel_p.append(p)
        sel_f.append(torch.where(torch.isfinite(avail[i]), avail[i], neg_inf[0]))
        avail = torch.where(_near_pose(cand_poses, p, rot_min_deg, trans_min),
                            neg_inf, avail)
    return torch.stack(sel_p), torch.stack(sel_f)


def _near_pose(poses, pose, rot_min_deg, trans_min):
    """[C] bool: within BOTH rotation and translation radii of `pose`."""
    cos = (torch.sum(poses[:, :3, :3] * pose[:3, :3], dim=(-1, -2)) - 1.0) / 2.0
    rot_deg = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    tr = torch.linalg.norm(poses[:, :3, 3] - pose[:3, 3], dim=-1)
    return (rot_deg < rot_min_deg) & (tr < trans_min)
