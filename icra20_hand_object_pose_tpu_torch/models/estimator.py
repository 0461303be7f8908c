"""Per-frame pose estimator and sequence tracker, track mode (counterpart of
models/estimator.py).

    est = Estimator(ObjectModel(mesh, device="cuda"),
                    make_t42_hand(device="cuda"), cfg)
    tracker = Tracker(est)
    tracker.state = tracker.state._replace(pose=pose0, initialized=True,
                                           fitness=1.0)
    for depth in frames:
        out = tracker.step(depth, hand_base_pose, hand_q)
        out.pose  # [4,4] model->camera

One tracked frame runs hand FK over sampled finger configs, the hand masks,
depth preprocessing and point-level hand removal (`_scene_prep`), then the
ROI crop, swarm init, self-occlusion mask and the PSO + ICP +
render-and-compare search (`_search`). The frame runs eagerly on the
tensors' device; on CUDA every correspondence search goes through kernel
K1 (ops/knn_cuda.py).

Init mode (the orientation prescreen and the hand-base refinement), and
with it tracking-loss recovery, is not ported yet: asking for it raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..ops import knn, knn_cuda, preprocess, pso, render
from ..utils import rng, se3
from ..utils.config import EstimatorConfig
from .hand import HandModel
from .object_model import ObjectModel

INIT_NOT_PORTED = (
    "init mode (orientation prescreen, hand-base refinement, tracking-loss "
    "re-registration) is not ported yet; it is the next slice on ROADMAP.md"
)


class FrameResult(NamedTuple):
    pose: torch.Tensor           # [4,4] model->camera
    fitness: torch.Tensor        # scalar, higher better
    coverage: torch.Tensor       # scalar in [0,1]
    fitness_trace: torch.Tensor  # [pso_iters]
    n_scene: torch.Tensor        # scalar, surviving scene points
    hyp_poses: torch.Tensor      # [H,4,4] competing-basin hypotheses
    hyp_fitness: torch.Tensor    # [H] (-inf = slot without a distinct basin)
    hand_delta: torch.Tensor | None = None  # [4,4]; identity in track mode


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
        corr_fn=None,
    ):
        self.obj = obj
        self.hand = hand if (hand is not None and cfg.hand.enabled) else None
        self.cfg = cfg
        self.device = obj.device
        if self.hand is not None and cfg.hand.base_refine_iters > 0:
            raise NotImplementedError(INIT_NOT_PORTED)
        if cfg.icp.fused_gn:
            raise NotImplementedError(
                "IcpConfig.fused_gn needs kernel K3 (nn_gn_batched), which is "
                "not ported yet")
        if corr_fn is None:
            # kernel K1: the plain version on CPU tensors, CUDA on the card
            corr_fn = knn_cuda.make_corr_fn()
        self.corr_fn = corr_fn
        cam = cfg.camera
        self.render_factor = max(1, cam.height // cfg.render_size)
        self.lo_h = cam.height // self.render_factor
        self.lo_w = cam.width // self.render_factor
        self.lo_fx = cam.fx / self.render_factor
        self.lo_fy = cam.fy / self.render_factor
        self.lo_cx = cam.cx / self.render_factor
        self.lo_cy = cam.cy / self.render_factor

    # -- frame program ------------------------------------------------------

    def _hand_tensors(self, gen, hand_base, hand_q, depth_m):
        """Sampled hand clouds -> (full-res drop depth, low-res occluder
        depth, flat hand cloud for point-level segmentation). With
        hand.config_select > 0 only the configs that best agree with the
        observed depth build the masks."""
        cfg = self.cfg
        cam = cfg.camera
        n_sel = cfg.hand.config_select
        clouds = self.hand.sampled_clouds(
            gen, hand_base, hand_q, cfg.hand.joint_sigma, cfg.hand.config_samples
        )                                                   # [K,Nh,3]
        if 0 < n_sel < clouds.shape[0]:
            dvalid = (depth_m > cfg.depth_min) & (depth_m < cfg.depth_max)
            d_lo_h, v_lo_h = preprocess.downsample_depth(
                depth_m, dvalid, self.render_factor)
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
            return hd_full, hd_full, flat
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
        return hd_full, hd_lo, flat

    def _scene_prep(self, gen, depth_m, hand_base, hand_q) -> tuple:
        """Object-independent per-frame work: hand masks, depth
        preprocessing, point-level hand removal. Returns (scene, weights,
        hd_lo, hd_hi)."""
        cfg = self.cfg
        cam = cfg.camera
        if self.hand is not None:
            hd_full, hd_lo, hand_flat = self._hand_tensors(
                gen, hand_base, hand_q, depth_m)
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
        return scene, weights, hd_lo, hd_hi

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
    ) -> FrameResult:
        """Per-object tracked search over a prepared scene: ROI crop, swarm
        init around the priors, explorer seeds from the super-Fibonacci
        grid, the self-occlusion mask, the PSO loop, the symmetry-branch
        snap and hypothesis extraction."""
        cfg = self.cfg
        cam = cfg.camera
        scene, weights, hd_lo, hd_hi = prep
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
        if n_hyp == 1:
            priors = prev_poses[0]
        else:
            # the best basin keeps ~2/3 of the swarm, the backups share the rest
            per = max(1, (n_particles // 3) // (n_hyp - 1))
            counts = [n_particles - per * (n_hyp - 1)] + [per] * (n_hyp - 1)
            prior_idx = torch.as_tensor(np.repeat(np.arange(n_hyp), counts),
                                        device=prev_poses.device)
            priors = prev_poses[prior_idx]
        tracked = se3.perturb_pose(gen, priors, rot_sigma, trans_sigma,
                                   shape=(n_particles,))
        kr = min(cfg.pso.scan_render_subset, render_pts.shape[0])

        render_vis = None
        if cfg.score.self_occlusion:
            render_vis = self._self_occlusion_mask(
                gen, prev_poses, render_pts, render_normals, render_w,
                rot_sigma, trans_sigma)

        # explorer seeds: an even stride of the randomly offset
        # super-Fibonacci grid, each translated so the model's predicted
        # visible-surface centroid lands on the observed centroid
        n_explore = int(round(n_particles * cfg.pso.explore_frac))
        explorer_seeds = None
        if n_explore > 0 and n_particles > n_explore:
            rotations = se3.super_fibonacci_rotations(n_particles, gen)
            T0 = se3.make_pose(rotations, torch.zeros(
                (n_particles, 3), dtype=rotations.dtype, device=rotations.device))
            pts_r = se3.transform_points(T0, render_pts[:kr])
            nrm_r = se3.rotate_vectors(T0, render_normals[:kr])
            vis_w = (nrm_r[..., 2] < 0.0) * render_w[:kr][None]
            wsum_r = torch.clamp(torch.sum(vis_w, -1, keepdim=True), min=1e-6)
            m_vis = torch.sum(pts_r * vis_w[..., None], 1) / wsum_r
            t = centroid[None] - m_vis + rng.normal(gen, (n_particles, 3)) * (
                0.3 * trans_sigma)
            global_init = se3.make_pose(rotations, t)
            idx = np.linspace(0, n_particles - 1, n_explore).round().astype(np.int64)
            explorer_seeds = global_init[torch.as_tensor(idx, device=t.device)]

        pso_cfg = dataclasses.replace(cfg.pso, particles=n_particles,
                                      iters=pso_iters, resample_after=0)
        result = pso.pso(
            gen, tracked,
            scene.points, scene.normals, weights,
            model_pts, model_normals,
            render_pts, render_normals, render_w,
            scene.depth, scene.valid, hd_lo,
            fx=self.lo_fx, fy=self.lo_fy, cx=self.lo_cx, cy=self.lo_cy,
            height=self.lo_h, width=self.lo_w,
            splat_radius=1,
            pso_cfg=pso_cfg, icp_cfg=cfg.icp, score_cfg=cfg.score,
            corr_fn=self.corr_fn,
            render_vis=render_vis,
            prior_pose=prev_poses[0],
            explorer_seeds=explorer_seeds,
            observed_neutral=scene.neutral,
            observed_hi=(
                scene.depth_full, scene.valid_full, scene.neutral_full, hd_hi,
                cam.fx, cam.fy, cam.cx, cam.cy, cam.height, cam.width,
            ),
        )
        best_pose = result.best_pose
        if symmetries.shape[0] > 1:
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
            hand_delta=torch.eye(4, dtype=best_pose.dtype, device=best_pose.device),
        )

    def _frame_step(self, gen, depth_m, prev_pose, hand_base, hand_q,
                    obj_tensors, *, rot_sigma, trans_sigma, roi_radius,
                    n_particles, pso_iters) -> FrameResult:
        """One tracked frame: scene prep, then the per-object search."""
        prep = self._scene_prep(gen, depth_m, hand_base, hand_q)
        return self._search(
            gen, prep, prev_pose, obj_tensors,
            rot_sigma=rot_sigma, trans_sigma=trans_sigma, roi_radius=roi_radius,
            n_particles=n_particles, pso_iters=pso_iters,
        )

    # -- public API ----------------------------------------------------------

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def frame_args(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                   key=None, *, mode: str = "track") -> tuple[tuple, dict]:
        """Validated (positional, keyword) arguments of `_frame_step`, as
        `estimate` passes them. Inputs may be numpy arrays or tensors."""
        cfg = self.cfg
        if mode == "init":
            raise NotImplementedError(INIT_NOT_PORTED)
        if mode != "track":
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
        if n_hyp > 1 and cfg.pso.particles < 2 * n_hyp:
            raise ValueError(
                f"{n_hyp} hypothesis priors need at least {2 * n_hyp} "
                f"particles; got {cfg.pso.particles}")
        dyn = (_generator(key, self.device), depth_m, prev_pose, hand_base,
               hand_q, self.obj.tensors())
        static = dict(
            rot_sigma=cfg.pso.rot_sigma, trans_sigma=cfg.pso.trans_sigma,
            roi_radius=max(1.5 * self.obj.diameter, 3.0 * cfg.pso.trans_sigma),
            n_particles=cfg.pso.particles, pso_iters=cfg.pso.iters,
        )
        return dyn, static

    @torch.no_grad()
    def estimate(self, depth_m, prev_pose, hand_base=None, hand_q=None,
                 key=None, *, mode: str = "track") -> FrameResult:
        """One frame -> SE(3): mode='track' searches around prev_pose. `key`
        is an int seed, a torch.Generator on the estimator's device, or
        injected rng.Draws."""
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
    """Frame-to-frame propagation with the re-registration watchdog. A
    frame whose watchdog asks for re-registration raises
    NotImplementedError until init mode is ported; seed the state at a
    known pose to track."""

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
        if self._need_init(st):
            raise NotImplementedError(INIT_NOT_PORTED)
        H = self.est.cfg.tracker.n_hypotheses
        key, sub = _split(st.key)
        if hand_base is not None and st.hand_delta is not None:
            hand_base = st.hand_delta @ self.est._tensor(hand_base)
        out = self.est.estimate(depth_m, self._priors(st), hand_base, hand_q,
                                key=sub, mode="track")
        self.state = TrackerState(
            pose=out.pose,
            frame_idx=st.frame_idx + 1,
            key=key,
            initialized=True,
            fitness=out.fitness,
            coverage=out.coverage,
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
            # a velocity needs two tracked poses in a row
            prev_pose=self.est._tensor(st.pose) if st.pose_tracked else None,
            pose_tracked=True,
            hand_delta=st.hand_delta,
        )
        return TrackResult(
            pose=out.pose, fitness=out.fitness, coverage=out.coverage,
            reinitialized=False, frame_idx=int(st.frame_idx),
            hyp_poses=out.hyp_poses if H > 1 else None,
            hyp_fitness=out.hyp_fitness if H > 1 else None,
        )
