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
swarm from it.

`estimate` runs a frame through the frame program of its mode and shapes
(utils/program.py, the counterpart of the reference's `_step_jit`):
captured once as a CUDA graph on the card and replayed, called directly on
the CPU. `_frame_step` is the traced function, callable eagerly as it is.

The correspondence searches go through kernel K1 (`corr_fn`, the default),
or K2 when the caller gives `nn_fn`; with `IcpConfig.fused_gn` the in-scan
refine and the explorer pulls go through kernel K3 (`gn_fn`). Unlike the
reference, which builds the fused `gn_fn` only on a TPU, the port builds it
on every device: on the CPU its wrapper runs the plain version, on the card
the CUDA kernel (ops/knn_cuda.py).

`_search` is written for a library of O objects (parallel/sharding.py
steps one as a single program); `Estimator.estimate` and `Tracker.step`
run it at O = 1.

With `mesh=` (parallel.make_mesh) this process is one rank of the mesh
dimension `axis_name`: it searches n_particles / n of the swarm and agrees
with the other ranks on the global best every iteration and on the
candidates before the final selection (ops/pso.py), so every rank returns
the same result. The scene prep draws the same numbers on every rank (it is
the same prep); the search's draws come from a generator folded from the
frame's seed and the rank (`rng.fold`), so a mesh of one draws another
stream than `mesh=None`, as the reference's `fold_in` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops import icp, knn_cuda, preprocess, pso, render, score
from ..parallel.mesh import is_writer, mesh_axis
from ..utils import profiling, program, rng, se3
from ..utils.config import EstimatorConfig
from .hand import HandModel
from .object_model import ObjectModel


def _ckpt_path(path: str) -> str:
    """np.savez appends .npz when it is missing; do the same on load, so
    that save('ckpt') / load('ckpt') round-trips."""
    return path if path.endswith(".npz") else path + ".npz"


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
        mesh=None,
        axis_name: str = "p",
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
        # the particle axis split over the mesh dimension `axis_name`: this
        # rank's index along it and the group the agreement gathers over
        self.mesh = mesh
        self.axis_name = axis_name
        self._shards, self._shard, self._group = 1, 0, None
        if mesh is not None:
            self._shards, self._shard = mesh_axis(mesh, axis_name)
            self._group = mesh.get_group(axis_name)
        cam = cfg.camera
        self.render_factor = max(1, cam.height // cfg.render_size)
        self.lo_h = cam.height // self.render_factor
        self.lo_w = cam.width // self.render_factor
        self.lo_fx = cam.fx / self.render_factor
        self.lo_fy = cam.fy / self.render_factor
        self.lo_cx = cam.cx / self.render_factor
        self.lo_cy = cam.cy / self.render_factor
        # the frame programs, one per static key (utils/program.py)
        self._programs = program.Programs()

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
            is_hand = self.hand.segment_mask(scene.points, hand_flat,
                                             cfg.hand.segment_dist)
            weights = weights * (~is_hand)
        return scene, weights, hd_lo, hd_hi, hand_delta

    @staticmethod
    def _stack_preps(preps: list) -> tuple:
        """`_scene_prep` results of O frames (or of the one frame that all
        objects share) as one prep whose tensors carry a leading axis: the
        form `_search` takes."""
        scenes, weights, hd_lo, hd_hi, deltas = zip(*preps)
        scene = preprocess.SceneCloud(*(torch.stack(f) for f in zip(*scenes)))
        delta = None if deltas[0] is None else torch.stack(deltas)
        return (scene, torch.stack(weights), torch.stack(hd_lo),
                torch.stack(hd_hi), delta)

    def _self_occlusion_mask(self, gen, prev_poses, render_pts,
                             render_normals, render_w, rot_sigma, trans_sigma):
        """[O,Nr] frame-constant render-sample visibility over the search
        region: the hypothesis priors ([O,Hy,4,4]) plus self_occ_union
        perturbed draws each, splat at the low-res tier; a sample stays
        visible if it passes the z-test under ANY region pose, or is
        near-grazing."""
        sc = self.cfg.score
        O, n_hyp = prev_poses.shape[:2]
        n_draw = sc.self_occ_union
        region = se3.perturb_pose(
            gen, prev_poses.repeat(1, n_draw, 1, 1), rot_sigma, trans_sigma,
            shape=(n_draw * n_hyp,),
        )
        mask_poses = torch.cat([prev_poses, region], dim=1)        # [O,M,4,4]
        M, Nr = mask_poses.shape[1], render_pts.shape[1]
        inc_pts = se3.transform_points(mask_poses, render_pts[:, None])  # [O,M,Nr,3]
        inc_nrm = se3.rotate_vectors(mask_poses, render_normals[:, None])
        d_inc = render.splat_depth_batched(
            inc_pts.reshape(O * M, Nr, 3),
            render_w[:, None].expand(O, M, Nr).reshape(O * M, Nr),
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w, radius=1,
        )                                                          # [O*M,h,w]
        z = inc_pts[..., 2]
        zs = torch.where(z > 1e-6, z, 1.0)
        ui = torch.clamp(torch.round(
            inc_pts[..., 0] / zs * self.lo_fx + self.lo_cx).long(), 0, self.lo_w - 1)
        vi = torch.clamp(torch.round(
            inc_pts[..., 1] / zs * self.lo_fy + self.lo_cy).long(), 0, self.lo_h - 1)
        d_at = torch.gather(d_inc.reshape(O * M, -1), 1,
                            (vi * self.lo_w + ui).reshape(O * M, Nr)
                            ).reshape(O, M, Nr)
        # slope-scaled margin: the splat reads a steep surface closer
        ray = inc_pts / torch.clamp(
            torch.linalg.norm(inc_pts, dim=-1, keepdim=True), min=1e-9)
        cosv = torch.clamp(-torch.sum(inc_nrm * ray, dim=-1), 1e-3, 1.0)
        tanv = torch.sqrt(1.0 - cosv ** 2) / cosv
        margin = sc.self_occ_margin + (
            1.5 * (z / self.lo_fx) * torch.clamp(tanv, max=4.0))
        vis_any = torch.any(d_at >= z - margin, dim=1)
        grazing = torch.any(tanv > sc.self_occ_tan_max, dim=1)
        return vis_any | grazing

    def _aligned_candidates(self, gen, rotations, render_pts, render_normals,
                            render_w, kr, centroid, trans_sigma):
        """Candidate poses [O,n,4,4] from orientations [O,n,3,3]: each
        translation puts the model's predicted visible-surface centroid
        (camera +z view) on the observed centroid [O,3], plus 0.3 *
        trans_sigma of noise. Draws: normals of shape (n, 3) per object."""
        O, n = rotations.shape[:2]
        T0 = se3.make_pose(rotations, torch.zeros(
            (O, n, 3), dtype=rotations.dtype, device=rotations.device))
        pts_r = se3.transform_points(T0, render_pts[:, None, :kr])  # [O,n,kr,3]
        nrm_r = se3.rotate_vectors(T0, render_normals[:, None, :kr])
        vis_w = (nrm_r[..., 2] < 0.0) * render_w[:, None, :kr]
        wsum_r = torch.clamp(torch.sum(vis_w, -1, keepdim=True), min=1e-6)
        m_vis = torch.sum(pts_r * vis_w[..., None], 2) / wsum_r
        t = (centroid[:, None] - m_vis
             + rng.normal(gen, (n, 3)) * (0.3 * trans_sigma))
        return se3.make_pose(rotations, t)

    def _prescreen(self, gen, scene, weights, hd_lo, obj_tensors, centroid, *,
                   score_cfg, trans_sigma, n_particles, prescreen, kr):
        """The init swarm from a dense orientation grid: one scoring pass
        (no ICP) over `prescreen` aligned super-Fibonacci candidates, the
        top prescreen_support re-ranked with scene support at 2x tau, then
        half the swarm from the best of those and half strided across the
        whole grid regardless of score. Per object: [O,n_particles,4,4]."""
        cfg = self.cfg
        model_pts, model_normals, render_pts, render_normals, render_w = \
            obj_tensors[:5]
        cand = self._aligned_candidates(
            gen, se3.super_fibonacci_rotations(prescreen, gen), render_pts,
            render_normals, render_w, kr, centroid, trans_sigma)
        cand_fit, _ = pso.score_particles(
            cand, render_pts[:, :kr], render_normals[:, :kr], render_w[:, :kr],
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
            km_i = min(cfg.tracker.reinit_icp_model_subset, model_pts.shape[1])
            ks_i = min(cfg.pso.icp_scene_subset, scene.points.shape[1])
            sup_idx = pso.top_k(cand_fit, n_sup)                   # [O,n_sup]
            # 2x tau: the candidates are unrefined (~1 cm off)
            supp = icp.scene_support(
                pso.take(cand, sup_idx), scene.points[:, :ks_i], weights[:, :ks_i],
                model_pts[:, :km_i], model_normals[:, :km_i],
                tau=2.0 * score_cfg.scene_cov_tau,
                nn_fn=self.nn_fn, corr_fn=self.corr_fn,
            )
            corr_fit = (pso.take(cand_fit, sup_idx)
                        + score_cfg.scene_cov_weight * (supp - 1.0))
            top = pso.take(sup_idx, pso.top_k(corr_fit, n_top))
        else:
            top = pso.top_k(cand_fit, n_top)
        stride_idx = np.linspace(0, prescreen - 1, n_particles - n_top
                                 ).round().astype(np.int64)
        return torch.cat([
            pso.take(cand, top),
            cand[:, program.constant(stride_idx, cand.device)]], dim=1)

    def _search(
        self,
        gen,
        prep: tuple,
        prev_poses: torch.Tensor,  # [O,Hy,4,4] hypothesis priors per object
        obj_tensors: tuple,        # each with a leading object axis
        *,
        rot_sigma,
        trans_sigma,
        roi_radius,
        n_particles: int,
        pso_iters: int,
        resample_after: int = 0,
        prescreen: int = 0,
        init_scoring: bool = False,
    ) -> FrameResult:
        """The search of O objects over prepared scenes, as one program:
        ROI crop, the swarms (perturbations of the priors when tracking; the
        prescreen or the aligned super-Fibonacci grid on a global init,
        `init_scoring`), explorer seeds and the self-occlusion masks when
        tracking, the PSO loop, the symmetry-branch snap and hypothesis
        extraction.

        `gen` is an rng.Stack of one source per object; `prep` a
        `_stack_preps` result whose leading axis is O (a frame per object)
        or 1 (one frame for all); `roi_radius` a float or one per object,
        the sigmas floats or [O,1,1] tensors. Every field of the result
        carries the object axis. A single frame is the O = 1 case
        (`_frame_step`). On a mesh `n_particles` is the whole swarm's: this
        rank searches its share with its own draws."""
        cfg = self.cfg
        if self.mesh is not None:
            if n_particles % self._shards:
                raise ValueError(
                    f"n_particles={n_particles} not divisible by mesh size "
                    f"{self._shards}")
            n_particles //= self._shards
            gen = rng.fold(gen, self._shard)
        cam = cfg.camera
        scene, weights, hd_lo, hd_hi, hand_delta = prep
        # global registration ranks candidates tens of mm apart under grasp
        # occlusion: hand-dropped pixels must not drag the truly occluded
        # pose's coverage there (tracking keeps the plain denominator)
        score_cfg = (dataclasses.replace(cfg.score, neutral_cov_exempt=True)
                     if init_scoring else cfg.score)
        O, n_hyp = prev_poses.shape[:2]
        dev = prev_poses.device
        profiling.stage("seed", dev)
        (model_pts, model_normals, render_pts, render_normals, render_w,
         symmetries, slide_axis, slide_extent) = obj_tensors
        # workspace crop around each track, unless it would leave < 32 points
        roi_center = prev_poses[:, 0, :3, 3]
        d2c = torch.sum((scene.points - roi_center[:, None]) ** 2, dim=-1)
        roi_r2 = program.constant(
            np.square(np.asarray(roi_radius, np.float64)).astype(np.float32),
            dev).reshape(-1, 1)
        roi_w = weights * (d2c < roi_r2)
        weights = torch.where((torch.sum(roi_w, dim=-1) >= 32.0)[:, None],
                              roi_w, weights)                     # [O,Ns]

        wsum = torch.clamp(torch.sum(weights, dim=-1), min=1e-9)
        centroid = icp.weighted_sum(scene.points, weights) / wsum[:, None]  # [O,3]
        kr = min(cfg.pso.scan_render_subset, render_pts.shape[1])
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
                priors = prev_poses
            else:
                # the best basin keeps ~2/3 of the swarm, the backups share the rest
                per = max(1, (n_particles // 3) // (n_hyp - 1))
                counts = [n_particles - per * (n_hyp - 1)] + [per] * (n_hyp - 1)
                prior_idx = program.constant(np.repeat(np.arange(n_hyp), counts),
                                             dev)
                priors = prev_poses[:, prior_idx]
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
                explorer_seeds = global_init[:, program.constant(idx, dev)]

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
            group=self._group,
            render_vis=render_vis,
            prior_pose=prev_poses[:, 0],
            prior_valid=not init_scoring,
            explorer_seeds=explorer_seeds,
            slide_axes=(slide_axis, slide_extent),
            observed_neutral=scene.neutral,
            observed_hi=(
                scene.depth_full, scene.valid_full, scene.neutral_full, hd_hi,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
            ),
        )
        best_pose = result.best_pose
        if symmetries.shape[1] > 1 and not init_scoring:
            best_pose = pso.snap_to_branch(best_pose, prev_poses[:, 0], symmetries,
                                           model_pts)
        hyp_poses, hyp_fitness = pso.diverse_hypotheses(
            result.cand_poses, result.cand_fitness, n_hyp,
            first_pose=best_pose, first_fitness=result.best_fitness,
        )
        if hand_delta is None:
            hand_delta = torch.eye(4, dtype=best_pose.dtype, device=dev)[None]
        out = FrameResult(
            pose=best_pose,
            fitness=result.best_fitness,
            coverage=result.best_coverage,
            fitness_trace=result.fitness_trace,
            n_scene=torch.sum(weights, dim=-1),
            hyp_poses=hyp_poses,
            hyp_fitness=hyp_fitness,
            hand_delta=hand_delta.expand(O, 4, 4),
        )
        profiling.stage_end(dev)
        return out

    def _frame_step(self, gen, depth_m, prev_pose, hand_base, hand_q,
                    obj_tensors, *, init_scoring=False, **search) -> FrameResult:
        """One frame: scene prep, then the search as a library of one."""
        profiling.stage("prep", depth_m.device)
        prep = self._stack_preps(
            [self._scene_prep(gen, depth_m, hand_base, hand_q, init_scoring)])
        prev_poses = prev_pose if prev_pose.dim() == 3 else prev_pose[None]
        out = self._search(rng.Stack([gen]), prep, prev_poses[None],
                           tuple(t[None] for t in obj_tensors),
                           init_scoring=init_scoring, **search)
        return FrameResult(*(t[0] for t in out))

    # -- public API ----------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def _statics(self, mode: str) -> dict:
        """The static arguments of `_frame_step` for `mode`: the reference's
        static_argnames and the mode's scalars."""
        cfg = self.cfg
        tr = cfg.tracker
        if mode == "track":
            return dict(
                rot_sigma=cfg.pso.rot_sigma, trans_sigma=cfg.pso.trans_sigma,
                roi_radius=max(1.5 * self.obj.diameter, 3.0 * cfg.pso.trans_sigma),
                n_particles=cfg.pso.particles, pso_iters=cfg.pso.iters,
            )
        if mode == "init":
            iters = 2 * cfg.pso.iters
            return dict(
                rot_sigma=tr.reinit_rot_sigma, trans_sigma=tr.reinit_trans_sigma,
                roi_radius=float("inf"),
                n_particles=tr.reinit_particles, pso_iters=iters,
                # explore, then exploit: no elite resample in the first half
                resample_after=iters // 2, prescreen=tr.reinit_prescreen,
                init_scoring=True,
            )
        raise ValueError(f"unknown mode {mode!r}")

    def _inputs(self, depth_m, prev_pose, hand_base, hand_q,
                n_particles: int) -> tuple:
        """The frame's tensor inputs (depth, prior, hand base, joints),
        validated by shape and with the hand's defaults filled in, as they
        were given: numpy arrays or tensors."""
        cam = self.cfg.camera
        depth_shape = tuple(np.shape(depth_m))
        if depth_shape != (cam.height, cam.width):
            raise ValueError(
                f"depth shape {depth_shape} != camera "
                f"({cam.height}, {cam.width}); fix CameraIntrinsics")
        prior_shape = tuple(np.shape(prev_pose))
        if prior_shape[-2:] != (4, 4) or len(prior_shape) not in (2, 3):
            raise ValueError(
                f"prev_pose must be [4,4] or [n_hyp,4,4], got {prior_shape}")
        J = self.hand.n_joints if self.hand is not None else 1
        hand_base = np.eye(4) if hand_base is None else hand_base
        hand_q = np.zeros(J) if hand_q is None else hand_q
        if self.hand is not None and tuple(np.shape(hand_q)) != (J,):
            raise ValueError(
                f"hand_q shape {tuple(np.shape(hand_q))} != ({J},) for this hand")
        # each prior needs particles on every shard
        n_hyp = prior_shape[0] if len(prior_shape) == 3 else 1
        per_shard = n_particles // self._shards
        if n_hyp > 1 and per_shard < 2 * n_hyp:
            raise ValueError(
                f"{n_hyp} hypothesis priors need at least {2 * n_hyp} "
                f"particles per shard; got {per_shard} "
                f"(n_particles={n_particles}"
                + (f" over {self._shards} shards)" if self.mesh is not None
                   else ")"))
        return depth_m, prev_pose, hand_base, hand_q

    def frame_args(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                   key=None, *, mode: str = "track") -> tuple[tuple, dict]:
        """Validated (positional, keyword) arguments of `_frame_step` on the
        estimator's device, for an eager call. Inputs may be numpy arrays or
        tensors."""
        static = self._statics(mode)
        inputs = self._inputs(depth_m, prev_pose, hand_base, hand_q,
                              static["n_particles"])
        dyn = (_generator(key, self.device), *map(self._tensor, inputs),
               self.obj.tensors())
        return dyn, static

    @torch.no_grad()
    def estimate(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                 key=None, *, mode: str = "track") -> FrameResult:
        """One frame -> SE(3): mode='track' searches around prev_pose;
        mode='init' runs the global search (frame 0, tracking-loss
        recovery). `key` is an int seed (None = 0): the frame runs through
        the program of its mode and shapes (captured at its first call on
        the card), with the draws of a torch.Generator seeded with it.
        A torch.Generator on the estimator's device or injected rng.Draws
        as `key`, and every frame of a sharded estimator, run `_frame_step`
        eagerly: test surfaces and the mesh, which the programs do not
        cover."""
        with profiling.span("estimate"), profiling.device_call(self.device):
            profiling.count("slots.init" if mode == "init" else "slots.track")
            if isinstance(key, (torch.Generator, rng.Draws)) or self.mesh is not None:
                dyn, static = self.frame_args(depth_m, prev_pose, hand_base, hand_q,
                                              key, mode=mode)
                return self._frame_step(*dyn, **static)
            static = self._statics(mode)
            inputs = self._inputs(depth_m, prev_pose, hand_base, hand_q,
                                  static["n_particles"])
            obj = self.obj.tensors()
            return self._programs(
                lambda src, *x, **st: self._frame_step(src.sources[0], *x, obj, **st),
                [int(key or 0)], inputs, self.device, **static)


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


def _split(key: int, n: int = 2) -> tuple[int, ...]:
    """n keys from a key, like jax.random.split: (next key, frame seed) at
    n = 2."""
    words = np.random.SeedSequence(int(key)).generate_state(n, np.uint64)
    return tuple(int(w) >> 1 for w in words)


class Tracker:
    """Frame-to-frame propagation with the re-registration watchdog: a frame
    runs the init program when the tracker is uninitialized or the last
    frame's fitness or coverage collapsed, and the track program
    otherwise."""

    def __init__(self, est: Estimator, seed: int = 0):
        self.est = est
        self.seed = seed
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
        with profiling.span("tracker.step", frame=True):
            return self._step(depth_m, hand_base, hand_q)

    def _step(self, depth_m, hand_base, hand_q) -> TrackResult:
        st = self.state
        H = self.est.cfg.tracker.n_hypotheses
        with profiling.span("tracker.watchdog"):
            need_init = self._need_init(st)
        if need_init:
            profiling.count("init.steps")
            profiling.count("init.needed")
        key, sub = _split(st.key)
        with profiling.span("tracker.priors"):
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

    # -- checkpoint / resume -------------------------------------------------

    def save(self, path: str) -> None:
        """Write the tracker's state to `path` (.npz, the reference's field
        names; `key` is this tracker's integer key). Over a sharded
        estimator global rank 0 writes it (every rank holds the same state)
        and every rank waits for it."""
        if not is_writer(self.est.mesh):
            torch.distributed.barrier()
            return
        st = self.state

        def arr(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        extra = {}
        if st.hyp_poses is not None:
            extra = dict(hyp_poses=arr(st.hyp_poses),
                         hyp_fitness=arr(st.hyp_fitness))
        if st.prev_pose is not None:
            extra["prev_pose"] = arr(st.prev_pose)
        if st.hand_delta is not None:
            extra["hand_delta"] = arr(st.hand_delta)
        np.savez(
            _ckpt_path(path),
            pose=arr(st.pose),
            frame_idx=np.asarray(st.frame_idx),
            key=np.asarray(st.key, np.uint64),
            initialized=np.asarray(bool(st.initialized)),
            fitness=arr(st.fitness),
            coverage=arr(st.coverage if st.coverage is not None else 1.0),
            pose_tracked=np.asarray(st.pose_tracked),
            **extra,
        )
        if self.est.mesh is not None:
            torch.distributed.barrier()

    def load(self, path: str) -> None:
        """Restore the state `save` wrote: tensors go to the estimator's
        device, `frame_idx` and `key` stay Python ints. A checkpoint of the
        JAX package loads too: every field but its threefry key carries
        over, and the key is re-derived from this tracker's seed and the
        frame index (convert.reseeded_key)."""
        z = np.load(_ckpt_path(path))
        t = self.est._tensor

        def opt(name):
            return t(z[name]) if name in z else None

        frame_idx = int(z["frame_idx"])
        if z["key"].ndim == 0:
            key = int(z["key"])
        else:
            from ..convert import reseeded_key
            key = reseeded_key(self.seed, frame_idx)
        self.state = TrackerState(
            pose=t(z["pose"]),
            frame_idx=frame_idx,
            key=key,
            initialized=bool(z["initialized"]),
            fitness=t(z["fitness"]),
            coverage=t(z["coverage"]) if "coverage" in z else t(1.0),
            hyp_poses=opt("hyp_poses"),
            hyp_fitness=opt("hyp_fitness"),
            prev_pose=opt("prev_pose"),
            # checkpoints from before the field: a stored prev_pose implies
            # the pose was tracked
            pose_tracked=(bool(z["pose_tracked"]) if "pose_tracked" in z
                          else "prev_pose" in z),
            hand_delta=opt("hand_delta"),
        )
