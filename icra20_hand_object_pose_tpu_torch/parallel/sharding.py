"""The device mesh and the multi-object library sweep (counterpart of
parallel/sharding.py).

    sweep = LibrarySweep(objects, make_t42_hand(), cfg)        # on "cuda"
    state = sweep.init_state()
    for depths, hand_bases, hand_qs in frames:                 # [O,H,W] ...
        state, res = sweep.step(state, depths, hand_bases, hand_qs)
        res.poses  # [O,4,4]

Every object of a library is tracked in one program on one device: the
model tensors are stacked [O,...] and the object axis is a batch axis of
the search (`Estimator._search`, ops/pso.py, ops/icp.py, ops/score.py),
not a Python loop over objects. The nearest-neighbour kernels take one
scene per object in a single launch (ops/knn_cuda.py). `Tracker.step` is
the O = 1 case of the same code.

A frame runs the track program, the init program (the single-object init:
prescreen, delayed resample, init-only scoring, the reinit swarm and ICP
cadence), or on a mixed frame both over the objects that need them,
merged by the watchdog mask. The one host read per frame is that [O] mask.

The mesh is SPMD over processes, one rank per shard (the reference shards
inside one program with `shard_map`): every rank runs this code on its
shard and meets the others only in collectives on a mesh dimension's
process group (`all_gather`). `make_mesh` builds a named
`torch.distributed.device_mesh.DeviceMesh` over an initialized process
group (torchrun, or `torch.distributed.init_process_group`); both live in
parallel/mesh.py, which the ops and models layers import, and are
re-exported here:

  - `Estimator(obj, hand, cfg, mesh=make_mesh(n, "p"))` splits one swarm
    over the ranks, agreeing on the global best every iteration;
  - `LibrarySweep(objects, hand, cfg, mesh=make_mesh(n, "obj"))` runs the
    objects O/n to a rank, with no communication until each step gathers
    the results; with a 2-D mesh, `make_mesh((n_obj, n_p), ("obj", "p"))`
    and `particle_axis="p"`, each object's swarm is also split over "p".

Every rank returns the whole result.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..models.estimator import Estimator, FrameResult, _ckpt_path, _generator, _split
from ..models.hand import HandModel
from ..models.object_model import ObjectModel
from ..ops import icp, pso, score
from ..utils import profiling, program, rng, se3
from ..utils.config import EstimatorConfig
from .mesh import all_gather, is_writer, make_mesh, mesh_axis  # noqa: F401


class SweepState(NamedTuple):
    """Per-object tracker state, batched: a library's whole resumable
    state."""
    poses: torch.Tensor        # [O,4,4]
    fitness: torch.Tensor      # [O]
    initialized: torch.Tensor  # [O] bool
    key: int                   # seed from which the next frame's seeds are split
    frame_idx: int
    coverage: torch.Tensor | None = None     # [O] watchdog second signal
    hyp_poses: torch.Tensor | None = None    # [O,H,4,4] competing basins (H>1)
    hyp_fitness: torch.Tensor | None = None  # [O,H]
    prev_poses: torch.Tensor | None = None   # [O,4,4] pose one frame earlier
    vel_ok: torch.Tensor | None = None       # [O] bool: prev_poses usable for
                                             # the constant-velocity prior (both
                                             # endpoints tracked frames)
    pose_tracked: torch.Tensor | None = None  # [O] bool: `poses` from a
                                              # tracked (not init) frame
    score_sum: torch.Tensor | None = None    # shared scene: [O] float64, each
                                             # candidate's identification scores
                                             # summed since the state began


class SweepResult(NamedTuple):
    poses: torch.Tensor          # [O,4,4]
    fitness: torch.Tensor        # [O]
    coverage: torch.Tensor       # [O]
    reinitialized: torch.Tensor  # [O] bool: which objects re-registered
    hyp_poses: torch.Tensor | None = None    # [O,H,4,4] when n_hypotheses > 1
    hyp_fitness: torch.Tensor | None = None  # [O,H]
    named: torch.Tensor | None = None        # shared scene: the candidate
                                             # named, an int64 scalar on the
                                             # device, -1 while none is
    score: torch.Tensor | None = None        # shared scene: [O] each
                                             # candidate's identification score


# a shared-scene program's result: FrameResult's fields, then each
# candidate's identification score [O]
SharedFrameResult = collections.namedtuple("SharedFrameResult",
                                           FrameResult._fields + ("score",))


# how far, in summed identification score, the named candidate has to lead
# every other. The scores of the steps since the state began are summed: a
# run of frames that tells the candidates apart by ~0.02-0.04 a step names
# one within tens of steps, and the few frames that fit a wrong one better
# cannot name it. At VGA a wrong candidate led the sums by up to 1.0 in a
# grasp's first 10 steps (16 seeds, PERF.md section 6): twice that
IDENTIFY_LEAD = 2.0


def identify(score_sum: torch.Tensor) -> torch.Tensor:
    """The candidate named from each candidate's summed identification
    scores [O]: the highest sum where it leads every other by more than
    IDENTIFY_LEAD, else -1 (none named yet; so on a tie). An int64 scalar,
    on the device; no host read."""
    best = torch.argmax(score_sum)
    others = torch.where(torch.arange(score_sum.shape[0], device=score_sum.device) == best,
                         float("-inf"), score_sum)
    lead = score_sum[best] - torch.amax(others)
    return torch.where(lead > IDENTIFY_LEAD, best, torch.full_like(best, -1))


def frame_seeds(key: int, n_objects: int) -> tuple[int, list[int], list[int]]:
    """(next key, the track program's per-object seeds, the init
    program's) from a sweep key: the key advances as a Tracker's does."""
    key, sub = _split(key)
    k_t, k_i = _split(sub)
    return key, list(_split(k_t, n_objects)), list(_split(k_i, n_objects))


class LibrarySweep:
    """Track O objects concurrently as one batched program per device.

    `shared_scene=True` is the model-library mode (one observed frame, O
    candidate models: which object is in the hand, and where?): step() then
    takes an unbatched depth [H,W] / hand_base [4,4] / hand_q [J], the
    object-independent frame work (`Estimator._scene_prep`) runs once, and
    every object searches that one scene. Object 0's result is bitwise the
    per-scene path's fed O copies of the frame with the same seeds. Each
    step names the candidate in the hand (`SweepResult.named`, on the
    device) once the evidence suffices: the one whose identification
    scores, summed over the state's steps, lead every other's by more than
    IDENTIFY_LEAD (`identify`); until one does, -1, and no candidate is
    named. One frame can fit two models alike (a face of the box and of the
    step prism), a run of frames rarely does. The identification score
    (`_identify_score`, inside the programs) is the search's own scoring of
    the pose each candidate serves, taken anew and alike for every
    candidate against the one prepared frame. A new grasp starts from a
    new state (`init_state`), as it has to for the poses too: the sums are
    never restarted within a state.

    With `mesh` (make_mesh), this rank runs the objects of its index along
    `axis_name`, O / n of them, from the seeds a one-process sweep gives
    them: object o of a sharded sweep is object o of the one-process sweep.
    `particle_axis` names a second mesh dimension over which each object's
    swarm is split as `Estimator(mesh=)` splits one. Every rank steps with
    the whole [O,...] inputs and returns the whole [O,...] state and result.

    The objects live on one device, the first object's (`device="cuda"` is
    `ObjectModel`'s default); step() puts its inputs there."""

    def __init__(
        self,
        objects: Sequence[ObjectModel],
        hand: HandModel | None,
        cfg: EstimatorConfig = EstimatorConfig(),
        mesh=None,
        axis_name: str = "obj",
        particle_axis: str | None = None,
        nn_fn=None,
        shared_scene: bool = False,
    ):
        if not objects:
            raise ValueError("need at least one object")
        if shared_scene and particle_axis is not None:
            raise ValueError(
                "shared_scene composes with the 1-D object mesh only; drop "
                "particle_axis or use the per-scene mode")
        shapes = {
            (tuple(o.model_pts.shape), tuple(o.render_pts.shape)) for o in objects
        }
        if len(shapes) != 1:
            raise ValueError(
                "objects must share model/render point counts; build them "
                "with the same ObjectModel(model_points=, render_points=)"
            )
        if len({o.device for o in objects}) != 1:
            raise ValueError("objects must live on one device")
        self.objects = list(objects)
        self.n_objects = O = len(objects)
        self.cfg = cfg
        self.mesh = mesh
        self.axis_name = axis_name
        self.particle_axis = particle_axis
        self.shared_scene = shared_scene
        # this rank's objects [lo, hi) and the group the results gather over
        self._lo, self._hi, self._group = 0, O, None
        if mesh is not None:
            n_obj, r = mesh_axis(mesh, axis_name)
            if O % n_obj:
                raise ValueError(
                    f"{O} objects not divisible by mesh axis {axis_name}={n_obj}")
            self._lo, self._hi = r * (O // n_obj), (r + 1) * (O // n_obj)
            self._group = mesh.get_group(axis_name)
        n_p = 1
        if particle_axis is not None:
            names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else None
            if mesh is None or particle_axis not in names:
                raise ValueError(
                    f"particle_axis {particle_axis!r} needs a mesh with that "
                    f"axis (got {names})")
            n_p, _ = mesh_axis(mesh, particle_axis)
        H = cfg.tracker.n_hypotheses
        if H > 1:
            for name, count in (("pso.particles", cfg.pso.particles),
                                ("tracker.reinit_particles",
                                 cfg.tracker.reinit_particles)):
                if count // n_p < 2 * H:
                    raise ValueError(
                        f"{H} hypotheses need at least {2 * H} particles per "
                        f"shard; {name}={count}"
                        + (f" over {n_p} particle shards" if n_p > 1 else ""))
        local = self.objects[self._lo:self._hi]
        # one estimator provides the frame program (with the particle group,
        # if any); the per-object tensors are passed to it stacked on a
        # leading object axis
        self._est = Estimator(
            local[0], hand, cfg, nn_fn=nn_fn,
            mesh=mesh if particle_axis is not None else None,
            axis_name=particle_axis or "p")
        self.device = self._est.device
        # symmetry groups identity-padded to the library's largest: the
        # padding rows are duplicates that never win the branch snap
        s_max = max(o.symmetries.shape[0] for o in objects)
        eye = torch.eye(4, device=self.device)
        self._obj_tensors = (
            torch.stack([o.model_pts for o in local]),
            torch.stack([o.model_normals for o in local]),
            torch.stack([o.render_pts for o in local]),
            torch.stack([o.render_normals for o in local]),
            torch.stack([o.render_w for o in local]),
            torch.stack([
                torch.cat([o.symmetries,
                           eye.expand(s_max - o.symmetries.shape[0], 4, 4)])
                for o in local
            ]),
            torch.stack([o.slide_axis for o in local]),
            torch.stack([o.slide_extent for o in local]),
        )
        self._diameters = np.asarray([o.diameter for o in local], np.float64)
        # the two programs, one per mode and prior shape (utils/program.py)
        self._programs = program.Programs()

    # -- the two programs ----------------------------------------------------

    def _statics(self, mode: str) -> dict:
        """`Estimator._statics` of `mode`, with one ROI radius per object of
        this rank when tracking."""
        static = self._est._statics(mode)
        if mode == "track":
            static["roi_radius"] = np.maximum(1.5 * self._diameters,
                                              3.0 * self.cfg.pso.trans_sigma)
        return static

    def _sweep_step(self, gens, depths, prev, hand_bases, hand_qs, *,
                    prep_gen=None, init_scoring=False, **search) -> FrameResult:
        """The traced program of this rank's objects (the counterpart of the
        reference's `_sweep_step` / `_sweep_step_shared`): the scene preps,
        then `Estimator._search` over the stacked preps. `gens` holds one
        source per object; the inputs are this rank's ([n,...], one frame
        when shared), `prev` [n,4,4] or [n,Hy,4,4]. A shared scene is
        prepared once on object 0's stream (the per-scene order):
        `prep_gen`, or the first source."""
        est = self._est
        profiling.stage("prep", self.device)
        if self.shared_scene:
            preps = [est._scene_prep(prep_gen or gens.sources[0], depths,
                                     hand_bases, hand_qs, init_scoring)]
        else:
            preps = [est._scene_prep(g, depths[o], hand_bases[o], hand_qs[o],
                                     init_scoring)
                     for o, g in enumerate(gens.sources)]
        prep = est._stack_preps(preps)
        out = est._search(
            gens, prep, prev if prev.dim() == 4 else prev[:, None],
            self._obj_tensors, init_scoring=init_scoring, **search)
        if not self.shared_scene:
            return out
        return SharedFrameResult(*out, self._identify_score(prep, out.pose))

    def _identify_score(self, prep: tuple, poses: torch.Tensor) -> torch.Tensor:
        """Each candidate's identification score [n] at its pose [n,4,4]:
        the full-resolution tier's projective fitness (fitness plus
        `coverage_weight` x coverage, the polish's scoring) plus
        `scene_cov_weight` x (the share of the frame's scene cloud that the
        posed model explains within `scene_cov_tau` - 1). Every candidate is
        scored alike: on the prepared frame's whole cloud (no crop), without
        the tracked scan's self-occlusion mask or the init's coverage
        exemption. Unlike the search's own fitness, whose support term
        comes from its last correspondence search, before the polish's last
        update and the finisher's moves, it scores the pose served."""
        est, sc, cam = self._est, self.cfg.score, self.cfg.camera
        scene, weights, _, hd_hi, _ = prep
        model_pts, model_normals, render_pts, render_normals, render_w = \
            self._obj_tensors[:5]
        sc_hi = (dataclasses.replace(sc, depth_tau=sc.depth_tau_fine)
                 if sc.depth_tau_fine > 0 else sc)
        fit, _ = pso.score_particles(
            poses[:, None], render_pts, render_normals, render_w,
            scene.depth_full, scene.valid_full, hd_hi,
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            height=cam.height, width=cam.width, splat_radius=1,
            score_cfg=sc_hi, subpixel=sc.subpixel, tier="full",
            observed_enc=score.encode_observed(
                scene.depth_full, scene.valid_full, sc.ghost_dilate,
                neutral=scene.neutral_full))
        if sc.scene_cov_weight > 0.0:
            supp = icp.scene_support(
                poses[:, None], scene.points, weights.expand(poses.shape[0], -1),
                model_pts, model_normals, tau=sc.scene_cov_tau,
                nn_fn=est.nn_fn, corr_fn=est.corr_fn)
            fit = fit + sc.scene_cov_weight * (supp - 1.0)
        return fit[:, 0]

    @torch.no_grad()
    def _run(self, keys, depths, prev, hand_bases, hand_qs, mode: str) -> FrameResult:
        """One program ('track' or 'init') over this rank's objects, with
        the arguments `Estimator.frame_args` builds for `mode`. Takes every
        object's inputs: `keys` one seed (or torch.Generator, or rng.Draws)
        per object, `prev` [O,4,4] or [O,Hy,4,4], depths etc. [O,...] (one
        frame when shared); every field of the result is [hi - lo, ...].

        Int seeds without a mesh run the program of this mode and prior
        shape (utils/program.py, the counterpart of `_sweep_jit`: captured
        once on the card, called directly on the CPU; the sweep's shared
        scene and object slice are fixed, so each sweep keeps its own).
        Generators, injected draws and a mesh's rank run `_sweep_step`
        eagerly."""
        with profiling.device_call(self.device):
            return self._call(keys, depths, prev, hand_bases, hand_qs, mode)

    def _call(self, keys, depths, prev, hand_bases, hand_qs, mode: str) -> FrameResult:
        static = self._statics(mode)
        lo, hi = self._lo, self._hi
        profiling.count("slots.init" if mode == "init" else "slots.track", hi - lo)
        if self._group is None and all(
                isinstance(k, (int, np.integer)) for k in keys):
            return self._programs(self._sweep_step, keys,
                                  (depths, prev, hand_bases, hand_qs),
                                  self.device, **static)
        est = self._est
        gens = rng.Stack([_generator(k, self.device) for k in keys[lo:hi]])
        depths, prev = est._tensor(depths), est._tensor(prev)[lo:hi]
        hand_bases, hand_qs = est._tensor(hand_bases), est._tensor(hand_qs)
        if self.shared_scene:
            # a rank without object 0 draws object 0's stream for the prep
            if lo != 0:
                static["prep_gen"] = _generator(keys[0], self.device)
        else:
            depths, hand_bases, hand_qs = (depths[lo:hi], hand_bases[lo:hi],
                                           hand_qs[lo:hi])
        return self._sweep_step(gens, depths, prev, hand_bases, hand_qs, **static)

    # -- public API ----------------------------------------------------------

    def init_state(self, seed: int = 0) -> SweepState:
        O, dev = self.n_objects, self.device
        H = self.cfg.tracker.n_hypotheses
        eye = torch.eye(4, device=dev)
        shared = self.shared_scene
        return SweepState(
            poses=eye.repeat(O, 1, 1),
            fitness=torch.zeros((O,), device=dev),
            initialized=torch.zeros((O,), dtype=torch.bool, device=dev),
            key=int(seed),
            frame_idx=0,
            coverage=torch.ones((O,), device=dev),
            hyp_poses=eye.repeat(O, H, 1, 1) if H > 1 else None,
            hyp_fitness=(torch.full((O, H), -float("inf"), device=dev)
                         if H > 1 else None),
            prev_poses=eye.repeat(O, 1, 1),
            vel_ok=torch.zeros((O,), dtype=torch.bool, device=dev),
            pose_tracked=torch.zeros((O,), dtype=torch.bool, device=dev),
            score_sum=torch.zeros((O,), dtype=torch.float64, device=dev) if shared else None,
        )

    def _prep(self, state: SweepState):
        """Per-frame glue, part 1: the frame's seeds, the watchdog mask
        (`Tracker.step`'s predicate per object) and both programs' prior
        stacks."""
        tr = self.cfg.tracker
        O, H = self.n_objects, tr.n_hypotheses
        key, keys_track, keys_init = frame_seeds(state.key, O)
        need_init = (~state.initialized) | (
            state.fitness < tr.fitness_reinit_threshold)
        if tr.coverage_reinit_threshold > 0.0 and state.coverage is not None:
            need_init = need_init | (state.initialized & (
                state.coverage < tr.coverage_reinit_threshold))
        # tracked-mode prior: competing-basin hypotheses (H > 1) or the
        # constant-velocity 2-prior stack (H == 1, motion_prior > 0)
        alpha = tr.motion_prior
        tiled = state.poses[:, None].repeat(1, H, 1, 1)
        if H > 1 and state.hyp_poses is not None:
            prev_t = torch.where(
                torch.isfinite(state.hyp_fitness)[..., None, None],
                state.hyp_poses, state.poses[:, None])
        elif H == 1 and alpha > 0.0:
            pp = state.prev_poses if state.prev_poses is not None else state.poses
            delta = se3.compose(state.poses, se3.inverse(pp))
            if alpha != 1.0:
                delta = se3.se3_exp(alpha * se3.se3_log(delta))
            vel_ok = (state.vel_ok if state.vel_ok is not None
                      else torch.zeros((O,), dtype=torch.bool, device=self.device))
            delta = torch.where(vel_ok[:, None, None], delta,
                                torch.eye(4, dtype=delta.dtype, device=self.device))
            predicted = se3.compose(delta, state.poses)
            prev_t = torch.stack([predicted, state.poses], dim=1)   # [O,2,4,4]
        else:
            prev_t = state.poses if H == 1 else tiled
        prev_i = state.poses if H == 1 else tiled
        return key, keys_track, keys_init, prev_t, prev_i, need_init

    def _merge(self, m, out_t: FrameResult | None, out_i: FrameResult | None):
        """Per-frame glue, part 2: this rank's results of the track and init
        programs merged by its objects' watchdog mask `m`: (pose, fitness,
        coverage, hyp_poses, hyp_fitness, score), the hypotheses None when
        H = 1, the identification score None without a shared scene."""
        H = self.cfg.tracker.n_hypotheses
        if out_t is None or out_i is None:
            out = out_i if out_t is None else out_t
            hyp = (out.hyp_poses, out.hyp_fitness) if H > 1 else (None, None)
            return (out.pose, out.fitness, out.coverage) + hyp + (
                out.score if self.shared_scene else None,)

        def sel(a, b):
            return torch.where(m.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

        hyp = ((sel(out_i.hyp_poses, out_t.hyp_poses),
                sel(out_i.hyp_fitness, out_t.hyp_fitness)) if H > 1
               else (None, None))
        scores = sel(out_i.score, out_t.score) if self.shared_scene else None
        return (sel(out_i.pose, out_t.pose), sel(out_i.fitness, out_t.fitness),
                sel(out_i.coverage, out_t.coverage)) + hyp + (scores,)

    def _gather(self, merged: tuple) -> tuple:
        """Every rank's merged results along the object axis, in object
        order: one all_gather of the fields packed [O/n, 18 + 17 H (+ 1)]."""
        pose, fitness, coverage, hyp_p, hyp_f, scores = merged
        n = pose.shape[0]
        fields = [pose.reshape(n, 16), fitness[:, None], coverage[:, None]]
        if hyp_p is not None:
            fields += [hyp_p.reshape(n, -1), hyp_f]
        if scores is not None:
            fields.append(scores[:, None])
        packed = all_gather(torch.cat(fields, dim=1), self._group)
        packed = packed.reshape(self.n_objects, -1)
        pose, fitness, coverage = (packed[:, :16].reshape(-1, 4, 4),
                                   packed[:, 16], packed[:, 17])
        if hyp_p is not None:
            H = hyp_f.shape[1]
            hyp_p = packed[:, 18:18 + 16 * H].reshape(-1, H, 4, 4)
            hyp_f = packed[:, 18 + 16 * H:18 + 17 * H]
        if scores is not None:
            scores = packed[:, -1]
        return pose, fitness, coverage, hyp_p, hyp_f, scores

    def _finish(self, state: SweepState, key, need_init, pose, fitness,
                coverage, hyp_p, hyp_f, scores=None):
        """Per-frame glue, part 3: the next state and the result from every
        object's merged results; with a shared scene, the candidate named."""
        O = self.n_objects
        H = self.cfg.tracker.n_hypotheses
        tracked = ~need_init
        named = score_sum = None
        if self.shared_scene:
            with profiling.span("sweep.identify"):
                score_sum = scores.double() + (
                    state.score_sum if state.score_sum is not None else 0.0)
                named = identify(score_sum)
                profiling.count("identify.steps")
                profiling.count_changes("identify.changes", named)
        was_tracked = (state.pose_tracked if state.pose_tracked is not None
                       else torch.zeros((O,), dtype=torch.bool, device=self.device))
        new_state = SweepState(
            poses=pose,
            fitness=fitness,
            initialized=torch.ones((O,), dtype=torch.bool, device=self.device),
            key=key,
            frame_idx=int(state.frame_idx) + 1,
            coverage=coverage,
            hyp_poses=hyp_p if H > 1 else None,
            hyp_fitness=hyp_f if H > 1 else None,
            # a velocity needs two tracked poses in a row: an init pose's
            # residual folded into it would extrapolate the error
            prev_poses=state.poses,
            vel_ok=tracked & was_tracked,
            pose_tracked=tracked,
            score_sum=score_sum,
        )
        return new_state, SweepResult(
            poses=pose, fitness=fitness, coverage=coverage,
            reinitialized=need_init,
            hyp_poses=hyp_p if H > 1 else None,
            hyp_fitness=hyp_f if H > 1 else None,
            named=named,
            score=scores,
        )

    def step(
        self,
        state: SweepState,
        depths,             # [O,H,W] meters; shared_scene: [H,W]
        hand_bases=None,    # [O,4,4]; shared: [4,4]
        hand_qs=None,       # [O,J]; shared: [J]
    ) -> tuple[SweepState, SweepResult]:
        """One frame for every object in the library. Inputs may be numpy
        arrays or tensors."""
        O, est = self.n_objects, self._est
        cam = self.cfg.camera
        J = est.hand.n_joints if est.hand is not None else 1
        shape = tuple(np.shape(depths))
        if self.shared_scene:
            if len(shape) != 2:
                raise ValueError(
                    f"shared_scene takes ONE frame [H,W], got {shape}")
            lead = ()
        else:
            if len(shape) != 3 or shape[0] != O:
                raise ValueError(
                    f"per-scene sweep takes [O,H,W] depths (O={O}), got "
                    f"{shape}; use shared_scene=True for one frame")
            lead = (O,)
        if shape[-2:] != (cam.height, cam.width):
            raise ValueError(
                f"depth shape {shape[-2:]} != camera "
                f"({cam.height}, {cam.width}); fix CameraIntrinsics")
        if hand_bases is None:
            hand_bases = torch.eye(4, device=self.device).expand(lead + (4, 4))
        if hand_qs is None:
            hand_qs = torch.zeros(lead + (J,), device=self.device)
        with profiling.span("sweep.step", frame=True):
            with profiling.span("sweep.prep"):
                key, keys_track, keys_init, prev_t, prev_i, need_init = \
                    self._prep(state)
            # the one host read per frame: the two programs have different
            # swarm shapes, so the mask of this rank's objects picks on the
            # host which of them run. The state is the same on every rank, so
            # every rank of a particle group runs the same programs (and
            # their collectives)
            m = need_init[self._lo:self._hi]
            with profiling.span("sweep.mask_read"):
                ni = m.cpu().numpy()
            if ni.any():
                profiling.count("init.steps")
                profiling.count("init.needed", int(ni.sum()))
            out_t = out_i = None
            if not ni.all():
                with profiling.span("sweep.run"):
                    out_t = self._run(keys_track, depths, prev_t, hand_bases,
                                      hand_qs, "track")
            if ni.any():
                with profiling.span("sweep.run"):
                    out_i = self._run(keys_init, depths, prev_i, hand_bases,
                                      hand_qs, "init")
            with profiling.span("sweep.merge"):
                merged = self._merge(m, out_t, out_i)
                if self._group is not None:
                    merged = self._gather(merged)
            with profiling.span("sweep.finish"):
                return self._finish(state, key, need_init, *merged)

    # -- checkpoint / resume -------------------------------------------------

    def save_state(self, state: SweepState, path: str) -> None:
        """Write `state` to `path` (.npz, the reference's field names;
        `key` is this package's integer key). On a mesh, global rank 0
        writes the file, the one that a one-process sweep writes, and every
        rank waits for it."""
        if not is_writer(self.mesh):
            dist.barrier()
            return
        extra = {}
        for name in ("coverage", "hyp_poses", "hyp_fitness", "prev_poses",
                     "vel_ok", "pose_tracked", "score_sum"):
            v = getattr(state, name)
            if v is not None:
                extra[name] = v.cpu().numpy()
        np.savez(
            _ckpt_path(path),
            poses=state.poses.cpu().numpy(),
            fitness=state.fitness.cpu().numpy(),
            initialized=state.initialized.cpu().numpy(),
            key=np.asarray(state.key, np.uint64),
            frame_idx=np.asarray(state.frame_idx, np.int32),
            **extra,
        )
        if self.mesh is not None:
            dist.barrier()

    def load_state(self, path: str, seed: int = 0) -> SweepState:
        """The state `save_state` wrote, on the sweep's device. A file of
        the JAX package loads too: its threefry key means nothing here, so
        the key is re-derived from `seed` and the frame index
        (convert.sweep_state_from_numpy)."""
        from ..convert import sweep_state_from_numpy

        return sweep_state_from_numpy(_ckpt_path(path), seed=seed,
                                      device=self.device)
