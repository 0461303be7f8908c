"""Per-frame pose estimator and sequence tracker (counterpart of
models/estimator.py).

    est = Estimator(ObjectModel(mesh), make_t42_hand(), cfg)   # on "cuda"
    tracker = Tracker(est)
    for depth in frames:
        out = tracker.step(depth, hand_base_pose, hand_q)
        out.pose  # [4,4] model->camera

A frame runs hand FK over sampled finger configs, the hand masks, depth
preprocessing and point-level hand removal (`_scene_prep`), then the ROI
crop, swarm init, self-occlusion mask and the PSO + ICP +
render-and-compare search (`_search`). mode="track" searches around the
prior; mode="init" (frame 0 and tracking-loss recovery) first refines the
hand base (auto-armed), scores a dense orientation prescreen and seeds the
swarm from it. The frame runs eagerly on the tensors' device.

The correspondence searches go through kernel K1 (`corr_fn`, the default),
or K2 when the caller gives `nn_fn`; with `IcpConfig.fused_gn` the in-scan
refine and the explorer pulls go through kernel K3 (`gn_fn`). Unlike the
reference, which builds the fused `gn_fn` only on a TPU, the port builds it
on every device: on the CPU its wrapper runs the plain version, on the card
the CUDA kernel (ops/knn_cuda.py).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import icp, knn, knn_cuda, preprocess, pso, render, score
from ..utils import rng, se3
from ..utils.config import EstimatorConfig
from .hand import HandModel
from .object_model import ObjectModel

class FrameResult(NamedTuple):
    pose: torch.Tensor           # [4,4] model->camera
    fitness: torch.Tensor        # scalar, higher better
    coverage: torch.Tensor       # scalar in [0,1]
    fitness_trace: torch.Tensor  # [pso_iters]
    n_scene: torch.Tensor        # scalar, surviving scene points
    hyp_poses: torch.Tensor      # [H,4,4] competing-basin hypotheses
    hyp_fitness: torch.Tensor    # [H] (-inf = slot without a distinct basin)
    hand_delta: torch.Tensor | None = None  # [4,4] auto-armed hand-base
                                            # correction (identity unless an
                                            # init frame accepted one)


def _generator(key, device: torch.device):
    """A frame's random source from `key`: an int seed (None = 0), a
    torch.Generator, or injected rng.Draws."""
    if isinstance(key, (torch.Generator, rng.Draws)):
        return key
    return torch.Generator(device=device).manual_seed(int(key or 0))


class Estimator:
    """One object + one hand + one camera on one device."""

    def __init__(
        self,
        obj: ObjectModel,
        hand: HandModel | None,
        cfg: EstimatorConfig = EstimatorConfig(),
        nn_fn=None,
        corr_fn=None,
    ):
        self.obj = obj
        self.hand = hand if (hand is not None and cfg.hand.enabled) else None
        self.cfg = cfg
        self.device = obj.device
        if corr_fn is None and nn_fn is None:
            # kernel K1: the plain version on CPU tensors, CUDA on the card
            corr_fn = knn_cuda.make_corr_fn()
        self.nn_fn = nn_fn
        self.corr_fn = corr_fn
        self.gn_fn = None
        if cfg.icp.fused_gn:
            # kernel K3 for the in-scan refine and the explorer pulls
            self.gn_fn = knn_cuda.make_gn_fn(
                maxd2=cfg.icp.max_corresp_dist ** 2,
                min_cos=math.cos(math.radians(cfg.icp.normal_angle_max_deg)),
                tau2=(cfg.score.scene_cov_tau ** 2
                      if cfg.score.scene_cov_weight > 0 else 0.0),
            )
        cam = cfg.camera
        self.render_factor = max(1, cam.height // cfg.render_size)
        self.lo_h = cam.height // self.render_factor
        self.lo_w = cam.width // self.render_factor
        self.lo_fx = cam.fx / self.render_factor
        self.lo_fy = cam.fy / self.render_factor
        self.lo_cx = cam.cx / self.render_factor
        self.lo_cy = cam.cy / self.render_factor

    # -- frame program ------------------------------------------------------

    def _hand_tensors(self, gen, hand_base, hand_q, depth_m,
                      init_scoring: bool = False):
        """Sampled hand clouds -> (full-res drop depth, low-res occluder
        depth, flat hand cloud for point-level segmentation, hand_delta).
        With hand.config_select > 0 only the configs that best agree with
        the observed depth build the masks. The hand base is first refined
        against the observed depth when hand.base_refine_iters > 0, or, in
        the init program, auto-armed (hand.base_refine_auto): the refined
        base is accepted only if its agreement gain beats
        base_refine_accept_margin, and hand_delta ([4,4], None outside the
        auto-armed path) is the accepted correction relative to the base
        this frame was given (exact identity when rejected)."""
        cfg = self.cfg
        cam = cfg.camera
        hc = cfg.hand
        n_sel = hc.config_select
        auto_refine = (init_scoring and hc.base_refine_iters == 0
                       and hc.base_refine_auto)
        hand_delta = None
        lo = dict(fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
                  height=self.lo_h, width=self.lo_w)
        if hc.base_refine_iters > 0 or auto_refine or (
                0 < n_sel < hc.config_samples):
            # observed depth on the low-res lattice the agreement scores on
            dvalid = (depth_m > cfg.depth_min) & (depth_m < cfg.depth_max)
            d_lo_h, v_lo_h = preprocess.downsample_depth(
                depth_m, dvalid, self.render_factor)
        if hc.base_refine_iters > 0 or auto_refine:
            refined = self.hand.refine_base(
                gen, d_lo_h, v_lo_h, hand_base, hand_q, **lo,
                iters=hc.base_refine_iters or 3,
                candidates=hc.base_refine_candidates,
                rot_sigma=hc.base_refine_rot_sigma,
                trans_sigma=hc.base_refine_trans_sigma,
                q_sigma=hc.joint_sigma,
            )
            if auto_refine:
                agree = self.hand.config_agreement(
                    self.hand.cloud(torch.stack([refined, hand_base]), hand_q),
                    d_lo_h, v_lo_h, **lo)
                accept = (agree[0] - agree[1]) > hc.base_refine_accept_margin
                hand_delta = torch.where(
                    accept, se3.compose(refined, se3.inverse(hand_base)),
                    torch.eye(4, dtype=hand_base.dtype, device=hand_base.device))
                hand_base = torch.where(accept, refined, hand_base)
            else:
                hand_base = refined
        clouds = self.hand.sampled_clouds(
            gen, hand_base, hand_q, hc.joint_sigma, hc.config_samples
        )                                                   # [K,Nh,3]
        if 0 < n_sel < clouds.shape[0]:
            agree = self.hand.config_agreement(
                clouds, d_lo_h, v_lo_h,
                fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
                height=self.lo_h, width=self.lo_w,
            )
            top = pso.top_k(agree, n_sel)
            clouds = clouds[top]
        flat = clouds.reshape(-1, 3)
        w = torch.ones(flat.shape[0], dtype=flat.dtype, device=flat.device)
        full = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
                    height=cam.height, width=cam.width, radius=2)
        if self.render_factor == 1:
            hd_full = render.splat_depth(flat, w, **full)
            return hd_full, hd_full, flat, hand_delta
        hd_lo = render.splat_depth(
            flat, w, fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx,
            cy=self.lo_cy, height=self.lo_h, width=self.lo_w, radius=1,
        )
        if cfg.hand.full_res_mask:
            hd_full = render.splat_depth(flat, w, **full)
        else:
            # nearest-upsample the low-res splat (the drop band only widens)
            f = self.render_factor
            up = hd_lo.repeat_interleave(f, 0).repeat_interleave(f, 1)
            hd_full = torch.full((cam.height, cam.width), float("inf"),
                                 dtype=up.dtype, device=up.device)
            h, w_ = min(cam.height, up.shape[0]), min(cam.width, up.shape[1])
            hd_full[:h, :w_] = up[:h, :w_]
        return hd_full, hd_lo, flat, hand_delta

    def _scene_prep(self, gen, depth_m, hand_base, hand_q,
                    init_scoring: bool = False) -> tuple:
        """Object-independent per-frame work: hand masks, depth
        preprocessing, point-level hand removal. Returns (scene, weights,
        hd_lo, hd_hi, hand_delta)."""
        cfg = self.cfg
        cam = cfg.camera
        hand_delta = None
        if self.hand is not None:
            hd_full, hd_lo, hand_flat, hand_delta = self._hand_tensors(
                gen, hand_base, hand_q, depth_m, init_scoring)
            # drop pixels on or behind the rendered hand
            extra_invalid = torch.isfinite(hd_full) & (
                depth_m > hd_full - cfg.hand.segment_dist)
            hd_hi = hd_full
        else:
            inf = float("inf")
            hd_lo = torch.full((self.lo_h, self.lo_w), inf, device=depth_m.device)
            hd_hi = torch.full(depth_m.shape, inf, device=depth_m.device)
            hand_flat = None
            extra_invalid = None
        scene = preprocess.preprocess_frame(
            gen, depth_m,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            depth_min=cfg.depth_min, depth_max=cfg.depth_max,
            n_points=cfg.scene_points, render_factor=self.render_factor,
            extra_invalid=extra_invalid,
            outlier_tau=cfg.outlier_tau,
            outlier_min_neighbors=cfg.outlier_min_neighbors,
        )
        weights = scene.weights
        if hand_flat is not None:
            d2h = knn.pairwise_sqdist(scene.points, hand_flat)
            is_hand = torch.amin(d2h, dim=-1) < cfg.hand.segment_dist ** 2
            weights = weights * (~is_hand)
        return scene, weights, hd_lo, hd_hi, hand_delta

    def _self_occlusion_mask(self, gen, prev_poses, render_pts,
                             render_normals, render_w, rot_sigma, trans_sigma):
        """[Nr] frame-constant render-sample visibility over the search
        region: the hypothesis priors plus self_occ_union perturbed draws
        each, splat at the low-res tier; a sample stays visible if it
        passes the z-test under ANY region pose, or is near-grazing."""
        sc = self.cfg.score
        n_hyp = prev_poses.shape[0]
        n_draw = sc.self_occ_union
        region = se3.perturb_pose(
            gen, prev_poses.repeat(n_draw, 1, 1), rot_sigma, trans_sigma,
            shape=(n_draw * n_hyp,),
        )
        mask_poses = torch.cat([prev_poses, region], dim=0)
        inc_pts = se3.transform_points(mask_poses, render_pts)     # [M,Nr,3]
        inc_nrm = se3.rotate_vectors(mask_poses, render_normals)
        d_inc = render.splat_depth_batched(
            inc_pts, render_w,
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w, radius=1,
        )                                                          # [M,h,w]
        z = inc_pts[..., 2]
        zs = torch.where(z > 1e-6, z, 1.0)
        ui = torch.clamp(torch.round(
            inc_pts[..., 0] / zs * self.lo_fx + self.lo_cx).long(), 0, self.lo_w - 1)
        vi = torch.clamp(torch.round(
            inc_pts[..., 1] / zs * self.lo_fy + self.lo_cy).long(), 0, self.lo_h - 1)
        d_at = torch.gather(d_inc.reshape(d_inc.shape[0], -1), 1,
                            vi * self.lo_w + ui)                   # [M,Nr]
        # slope-scaled margin: the splat reads a steep surface closer
        ray = inc_pts / torch.clamp(
            torch.linalg.norm(inc_pts, dim=-1, keepdim=True), min=1e-9)
        cosv = torch.clamp(-torch.sum(inc_nrm * ray, dim=-1), 1e-3, 1.0)
        tanv = torch.sqrt(1.0 - cosv ** 2) / cosv
        margin = sc.self_occ_margin + (
            1.5 * (z / self.lo_fx) * torch.clamp(tanv, max=4.0))
        vis_any = torch.any(d_at >= z - margin, dim=0)
        grazing = torch.any(tanv > sc.self_occ_tan_max, dim=0)
        return vis_any | grazing

    def _aligned_candidates(self, gen, rotations, render_pts, render_normals,
                            render_w, kr, centroid, trans_sigma):
        """Candidate poses from orientations: each translation puts the
        model's predicted visible-surface centroid (camera +z view) on the
        observed centroid, plus 0.3 * trans_sigma of noise. Draws: normals
        of shape (n, 3)."""
        n = rotations.shape[0]
        T0 = se3.make_pose(rotations, torch.zeros(
            (n, 3), dtype=rotations.dtype, device=rotations.device))
        pts_r = se3.transform_points(T0, render_pts[:kr])
        nrm_r = se3.rotate_vectors(T0, render_normals[:kr])
        vis_w = (nrm_r[..., 2] < 0.0) * render_w[:kr][None]
        wsum_r = torch.clamp(torch.sum(vis_w, -1, keepdim=True), min=1e-6)
        m_vis = torch.sum(pts_r * vis_w[..., None], 1) / wsum_r
        t = centroid[None] - m_vis + rng.normal(gen, (n, 3)) * (0.3 * trans_sigma)
        return se3.make_pose(rotations, t)

    def _prescreen(self, gen, scene, weights, hd_lo, obj_tensors, centroid, *,
                   score_cfg, trans_sigma, n_particles, prescreen, kr):
        """The init swarm from a dense orientation grid: one scoring pass
        (no ICP) over `prescreen` aligned super-Fibonacci candidates, the
        top prescreen_support re-ranked with scene support at 2x tau, then
        half the swarm from the best of those and half strided across the
        whole grid regardless of score."""
        cfg = self.cfg
        (model_pts, model_normals, render_pts, render_normals, render_w,
         _) = obj_tensors
        cand = self._aligned_candidates(
            gen, se3.super_fibonacci_rotations(prescreen, gen), render_pts,
            render_normals, render_w, kr, centroid, trans_sigma)
        cand_fit, _ = pso.score_particles(
            cand, render_pts[:kr], render_normals[:kr], render_w[:kr],
            scene.depth, scene.valid, hd_lo,
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w,
            splat_radius=1, score_cfg=score_cfg,
            observed_enc=score.encode_observed(
                scene.depth, scene.valid, score_cfg.ghost_dilate,
                neutral=scene.neutral),
        )
        n_top = n_particles // 2
        n_sup = min(max(cfg.tracker.prescreen_support, 2 * n_top), prescreen)
        if score_cfg.scene_cov_weight > 0.0 and cfg.tracker.prescreen_support > 0:
            km_i = min(cfg.tracker.reinit_icp_model_subset, model_pts.shape[0])
            ks_i = min(cfg.pso.icp_scene_subset, scene.points.shape[0])
            sup_idx = pso.top_k(cand_fit, n_sup)
            # 2x tau: the candidates are unrefined (~1 cm off)
            supp = icp.scene_support(
                cand[sup_idx], scene.points[:ks_i], weights[:ks_i],
                model_pts[:km_i], model_normals[:km_i],
                tau=2.0 * score_cfg.scene_cov_tau,
                nn_fn=self.nn_fn, corr_fn=self.corr_fn,
            )
            corr_fit = cand_fit[sup_idx] + score_cfg.scene_cov_weight * (supp - 1.0)
            top = sup_idx[pso.top_k(corr_fit, n_top)]
        else:
            top = pso.top_k(cand_fit, n_top)
        stride_idx = np.linspace(0, prescreen - 1, n_particles - n_top
                                 ).round().astype(np.int64)
        return torch.cat([cand[top],
                          cand[torch.as_tensor(stride_idx, device=cand.device)]])

    def _search(
        self,
        gen,
        prep: tuple,
        prev_pose: torch.Tensor,   # [4,4], or [Hy,4,4] hypothesis priors
        obj_tensors: tuple,
        *,
        rot_sigma: float,
        trans_sigma: float,
        roi_radius: float,
        n_particles: int,
        pso_iters: int,
        resample_after: int = 0,
        prescreen: int = 0,
        init_scoring: bool = False,
    ) -> FrameResult:
        """Per-object search over a prepared scene: ROI crop, the swarm
        (perturbations of the priors when tracking; the prescreen or the
        aligned super-Fibonacci grid on a global init, `init_scoring`),
        explorer seeds and the self-occlusion mask when tracking, the PSO
        loop, the symmetry-branch snap and hypothesis extraction."""
        cfg = self.cfg
        cam = cfg.camera
        scene, weights, hd_lo, hd_hi, hand_delta = prep
        # global registration ranks candidates tens of mm apart under grasp
        # occlusion: hand-dropped pixels must not drag the truly occluded
        # pose's coverage there (tracking keeps the plain denominator)
        score_cfg = (dataclasses.replace(cfg.score, neutral_cov_exempt=True)
                     if init_scoring else cfg.score)
        prev_poses = prev_pose if prev_pose.dim() == 3 else prev_pose[None]
        n_hyp = prev_poses.shape[0]
        (model_pts, model_normals, render_pts, render_normals, render_w,
         symmetries) = obj_tensors
        # workspace crop around the track, unless it would leave < 32 points
        roi_center = prev_poses[0, :3, 3]
        d2c = torch.sum((scene.points - roi_center) ** 2, dim=-1)
        roi_w = weights * (d2c < roi_radius * roi_radius)
        weights = torch.where(torch.sum(roi_w) >= 32.0, roi_w, weights)

        wsum = torch.clamp(torch.sum(weights), min=1e-9)
        centroid = torch.sum(scene.points * weights[:, None], 0) / wsum
        kr = min(cfg.pso.scan_render_subset, render_pts.shape[0])
        render_vis = None
        explorer_seeds = None
        if init_scoring:
            if prescreen > n_particles:
                poses0 = self._prescreen(
                    gen, scene, weights, hd_lo, obj_tensors, centroid,
                    score_cfg=score_cfg, trans_sigma=trans_sigma,
                    n_particles=n_particles, prescreen=prescreen, kr=kr)
            else:
                poses0 = self._aligned_candidates(
                    gen, se3.super_fibonacci_rotations(n_particles, gen),
                    render_pts, render_normals, render_w, kr, centroid,
                    trans_sigma)
        else:
            if n_hyp == 1:
                priors = prev_poses[0]
            else:
                # the best basin keeps ~2/3 of the swarm, the backups share the rest
                per = max(1, (n_particles // 3) // (n_hyp - 1))
                counts = [n_particles - per * (n_hyp - 1)] + [per] * (n_hyp - 1)
                prior_idx = torch.as_tensor(np.repeat(np.arange(n_hyp), counts),
                                            device=prev_poses.device)
                priors = prev_poses[prior_idx]
            poses0 = se3.perturb_pose(gen, priors, rot_sigma, trans_sigma,
                                      shape=(n_particles,))
            if cfg.score.self_occlusion:
                render_vis = self._self_occlusion_mask(
                    gen, prev_poses, render_pts, render_normals, render_w,
                    rot_sigma, trans_sigma)
            # explorer seeds: an even stride of the randomly offset
            # super-Fibonacci grid, aligned to the observed centroid
            n_explore = int(round(n_particles * cfg.pso.explore_frac))
            if n_explore > 0 and n_particles > n_explore:
                global_init = self._aligned_candidates(
                    gen, se3.super_fibonacci_rotations(n_particles, gen),
                    render_pts, render_normals, render_w, kr, centroid,
                    trans_sigma)
                idx = np.linspace(0, n_particles - 1, n_explore).round().astype(np.int64)
                explorer_seeds = global_init[torch.as_tensor(idx, device=centroid.device)]

        pso_cfg = dataclasses.replace(cfg.pso, particles=n_particles,
                                      iters=pso_iters,
                                      resample_after=resample_after)
        if init_scoring:
            # global registration keeps the heavier in-scan ICP cadence
            tr = cfg.tracker
            pso_cfg = dataclasses.replace(
                pso_cfg, icp_iters_inner=tr.reinit_icp_iters_inner,
                icp_model_subset=tr.reinit_icp_model_subset)
        result = pso.pso(
            gen, poses0,
            scene.points, scene.normals, weights,
            model_pts, model_normals,
            render_pts, render_normals, render_w,
            scene.depth, scene.valid, hd_lo,
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w,
            splat_radius=1,
            pso_cfg=pso_cfg, icp_cfg=cfg.icp, score_cfg=score_cfg,
            nn_fn=self.nn_fn, corr_fn=self.corr_fn, gn_fn=self.gn_fn,
            render_vis=render_vis,
            prior_pose=prev_poses[0],
            prior_valid=not init_scoring,
            explorer_seeds=explorer_seeds,
            observed_neutral=scene.neutral,
            observed_hi=(
                scene.depth_full, scene.valid_full, scene.neutral_full, hd_hi,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
            ),
        )
        best_pose = result.best_pose
        if symmetries.shape[0] > 1 and not init_scoring:
            best_pose = pso.snap_to_branch(best_pose, prev_poses[0], symmetries,
                                           model_pts)
        hyp_poses, hyp_fitness = pso.diverse_hypotheses(
            result.cand_poses, result.cand_fitness, n_hyp,
            first_pose=best_pose, first_fitness=result.best_fitness,
        )
        return FrameResult(
            pose=best_pose,
            fitness=result.best_fitness,
            coverage=result.best_coverage,
            fitness_trace=result.fitness_trace,
            n_scene=torch.sum(weights),
            hyp_poses=hyp_poses,
            hyp_fitness=hyp_fitness,
            hand_delta=(torch.eye(4, dtype=best_pose.dtype, device=best_pose.device)
                        if hand_delta is None else hand_delta),
        )

    def _frame_step(self, gen, depth_m, prev_pose, hand_base, hand_q,
                    obj_tensors, *, init_scoring=False, **search) -> FrameResult:
        """One frame: scene prep, then the per-object search."""
        prep = self._scene_prep(gen, depth_m, hand_base, hand_q, init_scoring)
        return self._search(gen, prep, prev_pose, obj_tensors,
                            init_scoring=init_scoring, **search)

    # -- public API ----------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def frame_args(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                   key=None, *, mode: str = "track") -> tuple[tuple, dict]:
        """Validated (positional, keyword) arguments of `_frame_step`, as
        `estimate` passes them. Inputs may be numpy arrays or tensors."""
        cfg = self.cfg
        tr = cfg.tracker
        if mode == "track":
            static = dict(
                rot_sigma=cfg.pso.rot_sigma, trans_sigma=cfg.pso.trans_sigma,
                roi_radius=max(1.5 * self.obj.diameter, 3.0 * cfg.pso.trans_sigma),
                n_particles=cfg.pso.particles, pso_iters=cfg.pso.iters,
            )
        elif mode == "init":
            iters = 2 * cfg.pso.iters
            static = dict(
                rot_sigma=tr.reinit_rot_sigma, trans_sigma=tr.reinit_trans_sigma,
                roi_radius=float("inf"),
                n_particles=tr.reinit_particles, pso_iters=iters,
                # explore, then exploit: no elite resample in the first half
                resample_after=iters // 2, prescreen=tr.reinit_prescreen,
                init_scoring=True,
            )
        else:
            raise ValueError(f"unknown mode {mode!r}")
        depth_m = self._tensor(depth_m)
        prev_pose = self._tensor(prev_pose)
        cam = cfg.camera
        if tuple(depth_m.shape) != (cam.height, cam.width):
            raise ValueError(
                f"depth shape {tuple(depth_m.shape)} != camera "
                f"({cam.height}, {cam.width}); fix CameraIntrinsics")
        if tuple(prev_pose.shape)[-2:] != (4, 4) or prev_pose.dim() not in (2, 3):
            raise ValueError(
                f"prev_pose must be [4,4] or [n_hyp,4,4], got {tuple(prev_pose.shape)}")
        J = self.hand.n_joints if self.hand is not None else 1
        hand_base = self._tensor(np.eye(4) if hand_base is None else hand_base)
        hand_q = self._tensor(np.zeros(J) if hand_q is None else hand_q)
        if self.hand is not None and tuple(hand_q.shape) != (J,):
            raise ValueError(
                f"hand_q shape {tuple(hand_q.shape)} != ({J},) for this hand")
        n_hyp = prev_pose.shape[0] if prev_pose.dim() == 3 else 1
        if n_hyp > 1 and static["n_particles"] < 2 * n_hyp:
            raise ValueError(
                f"{n_hyp} hypothesis priors need at least {2 * n_hyp} "
                f"particles; got {static['n_particles']}")
        dyn = (_generator(key, self.device), depth_m, prev_pose, hand_base,
               hand_q, self.obj.tensors())
        return dyn, static

    @torch.no_grad()
    def estimate(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                 key=None, *, mode: str = "track") -> FrameResult:
        """One frame -> SE(3): mode='track' searches around prev_pose;
        mode='init' runs the global search (frame 0, tracking-loss
        recovery). `key` is an int seed, a torch.Generator on the
        estimator's device, or injected rng.Draws."""
        dyn, static = self.frame_args(depth_m, prev_pose, hand_base, hand_q,
                                      key, mode=mode)
        return self._frame_step(*dyn, **static)


class TrackerState(NamedTuple):
    """The tracker's whole state."""
    pose: torch.Tensor     # [4,4] last committed pose
    frame_idx: int
    key: int               # seed from which the next frame's seed is split
    initialized: torch.Tensor | bool
    fitness: torch.Tensor | float        # last frame's fitness
    coverage: torch.Tensor | float | None = None  # last frame's coverage
    hyp_poses: torch.Tensor | None = None   # [H,4,4] competing basins (H>1)
    hyp_fitness: torch.Tensor | None = None  # [H]
    prev_pose: torch.Tensor | None = None   # [4,4] pose one frame earlier
    pose_tracked: bool = False              # `pose` came from a tracked frame
    hand_delta: torch.Tensor | None = None  # [4,4] hand-base correction


class TrackResult(NamedTuple):
    pose: torch.Tensor
    fitness: torch.Tensor
    coverage: torch.Tensor
    reinitialized: bool
    frame_idx: int
    hyp_poses: torch.Tensor | None = None
    hyp_fitness: torch.Tensor | None = None


def _split(key: int) -> tuple[int, int]:
    """(next key, frame seed) from a key, like jax.random.split."""
    a, b = np.random.SeedSequence(int(key)).generate_state(2, np.uint64)
    return int(a) >> 1, int(b) >> 1


class Tracker:
    """Frame-to-frame propagation with the re-registration watchdog: a frame
    runs the init program when the tracker is uninitialized or the last
    frame's fitness or coverage collapsed, and the track program
    otherwise."""

    def __init__(self, est: Estimator, seed: int = 0):
        self.est = est
        self.state = TrackerState(
            pose=torch.eye(4, device=est.device),
            frame_idx=0,
            key=seed,
            initialized=False,
            fitness=0.0,
            coverage=1.0,
        )

    def _need_init(self, st: TrackerState) -> bool:
        """The watchdog: uninitialized, fitness collapse, or coverage
        collapse (one host read of the last frame's scalars)."""
        tr = self.est.cfg.tracker
        initialized = bool(st.initialized)
        need = (not initialized) or float(st.fitness) < tr.fitness_reinit_threshold
        if tr.coverage_reinit_threshold > 0.0 and st.coverage is not None:
            need |= initialized and float(st.coverage) < tr.coverage_reinit_threshold
        return need

    def _priors(self, st: TrackerState) -> torch.Tensor:
        """The tracked frame's prior(s): competing hypotheses, or the last
        pose plus its constant-velocity extrapolation, or the last pose."""
        tr = self.est.cfg.tracker
        H, alpha = tr.n_hypotheses, tr.motion_prior
        pose = self.est._tensor(st.pose)
        if H > 1 and st.hyp_poses is not None:
            return torch.where(torch.isfinite(st.hyp_fitness)[:, None, None],
                               st.hyp_poses, pose[None])
        if H == 1 and alpha > 0.0:
            if st.prev_pose is not None:
                delta = se3.compose(pose, se3.inverse(st.prev_pose))
                if alpha != 1.0:
                    delta = se3.se3_exp(alpha * se3.se3_log(delta))
                predicted = se3.compose(delta, pose)
            else:
                predicted = pose
            return torch.stack([predicted, pose])
        return pose[None].repeat(H, 1, 1) if H > 1 else pose

    def step(self, depth_m, hand_base=None, hand_q=None) -> TrackResult:
        st = self.state
        H = self.est.cfg.tracker.n_hypotheses
        need_init = self._need_init(st)
        key, sub = _split(st.key)
        if hand_base is not None and st.hand_delta is not None:
            hand_base = st.hand_delta @ self.est._tensor(hand_base)
        if need_init:
            pose = self.est._tensor(st.pose)
            prior = pose[None].repeat(H, 1, 1) if H > 1 else pose
        else:
            prior = self._priors(st)
        out = self.est.estimate(depth_m, prior, hand_base, hand_q, key=sub,
                                mode="init" if need_init else "track")
        # an auto-armed init frame's base correction (identity when it was
        # rejected) composes left of the running one: the frame already saw
        # the corrected base
        hand_delta = st.hand_delta
        hc = self.est.cfg.hand
        if (need_init and self.est.hand is not None
                and hc.base_refine_auto and hc.base_refine_iters == 0):
            hand_delta = (out.hand_delta if hand_delta is None
                          else out.hand_delta @ hand_delta)
        self.state = TrackerState(
            pose=out.pose,
            frame_idx=st.frame_idx + 1,
            key=key,
            initialized=True,
            fitness=out.fitness,
            coverage=out.coverage,
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
            # a velocity needs two tracked poses in a row: it restarts after
            # an init, and for one more frame
            prev_pose=(self.est._tensor(st.pose)
                       if (not need_init and st.pose_tracked) else None),
            pose_tracked=not need_init,
            hand_delta=hand_delta,
        )
        return TrackResult(
            pose=out.pose, fitness=out.fitness, coverage=out.coverage,
            reinitialized=need_init, frame_idx=int(st.frame_idx),
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
        )
