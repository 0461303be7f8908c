"""Config system.

Rebuild of the reference's yaml-cpp `ConfigParser` (SURVEY.md §3 "Config
parser": config.yaml with data paths, camera intrinsics, PSO/ICP params).
Here: frozen dataclasses whose fields are jit-static, plus YAML loading
for drop-in compatibility with reference-style config files.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera model. Units: pixels (f, c), meters (depth_scale maps
    raw depth units -> meters; 1e-3 for 16-bit millimeter PNGs)."""
    fx: float = 615.0
    fy: float = 615.0
    cx: float = 320.0
    cy: float = 240.0
    width: int = 640
    height: int = 480
    depth_scale: float = 1e-3

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    def scaled(self, factor: float) -> "CameraIntrinsics":
        """Intrinsics for a resolution scaled by `factor`."""
        return dataclasses.replace(
            self,
            fx=self.fx * factor,
            fy=self.fy * factor,
            cx=self.cx * factor,
            cy=self.cy * factor,
            width=int(round(self.width * factor)),
            height=int(round(self.height * factor)),
        )


@dataclass(frozen=True)
class IcpConfig:
    """Point-to-plane ICP (SURVEY.md §3; BASELINE.json config 1)."""
    iters: int = 12                     # final-polish GN iterations; the
                                        # polish starts near-converged (PSO
                                        # best), 12 suffices and the fixed
                                        # 30 cost ~40ms/frame at P=1
    max_corresp_dist: float = 0.02      # meters; gate for correspondences
    normal_angle_max_deg: float = 60.0  # reject normal-incompatible pairs
    damping: float = 1e-6               # Levenberg damping on the 6x6 solve
    step_scale: float = 1.0
    fused_gn: bool = False              # in-scan refine via the fully
                                        # fused NN+GN Pallas kernel
                                        # (knn_pallas.nn_gn_batched): the
                                        # normal equations are built
                                        # in-kernel and the matched-point
                                        # streams never reach HBM. Each
                                        # inner iteration is then ONE
                                        # search x ONE linearization
                                        # (gn_reps does not apply — the
                                        # kernel deliberately does not
                                        # emit the matched points a
                                        # re-linearization would need).
                                        # TPU only; A/B before enabling.
    gn_reps: int = 3                    # GN re-linearizations per NN
                                        # search (correspondence reuse —
                                        # each rep re-poses the matched
                                        # pairs by the increment; the NN
                                        # search dominates ICP cost).
                                        # A/B r2: (2 searches x 2 reps)
                                        # beat (3 x 1) on both wall time
                                        # and tracked ADD. A/B r3 (6
                                        # noisy seeds x asym+mug, robust
                                        # stats): 1 search x 3 reps +
                                        # model subset 256 beat 2x2/512
                                        # on MEDIAN tracked ADD (1.1-1.2
                                        # vs 1.65-1.75 mm) with
                                        # comparable tails, at 34 vs
                                        # 46 ms/frame


@dataclass(frozen=True)
class PsoConfig:
    """Particle swarm over pose hypotheses (SURVEY.md §3; BASELINE config 3)."""
    particles: int = 512
    iters: int = 10
    rot_sigma: float = 0.12             # radians, initial perturbation scale
    trans_sigma: float = 0.015          # meters
    sigma_decay: float = 0.7            # anneal per PSO iteration
    icp_every: int = 1                  # run ICP refine every k PSO iters.
                                        # every=2 was A/B'd r3 (asym+mug
                                        # noisy, 18 runs each): saves
                                        # ~10 ms/frame (in-scan ICP is
                                        # ~19 ms of 42) but costs +15%
                                        # tracked ADD-S on the mug
                                        # (2.13 -> 2.44 mm) — rejected;
                                        # the noisy-VGA ≤1 mm bar has no
                                        # slack for it
    icp_iters_inner: int = 1            # NN-search ICP iters inside each
                                        # PSO step (each runs icp.gn_reps
                                        # GN re-linearizations; A/B r2:
                                        # 2x2 beat 3x1 and 5x1. A/B r3:
                                        # 1 search x 3 reps halves the
                                        # in-scan search count — see
                                        # IcpConfig.gn_reps — the scan
                                        # repeats the pull every
                                        # iteration anyway)
    icp_scene_subset: int = 512         # stochastic inner ICP: scene points
                                        # (768 A/B'd r3: slower AND worse)
    icp_model_subset: int = 256         # stochastic inner ICP: model points
                                        # (512 -> 256 A/B r3: -4 ms with
                                        # the better median; the polish
                                        # still uses the full clouds)
    elite_frac: float = 0.25            # resample worst particles around best
    resample_after: int = 0             # first PSO iteration at which the
                                        # elite resample may fire; init
                                        # mode delays it (premature
                                        # exploitation collapses swarm
                                        # diversity onto the first decent
                                        # basin before SO(3) is explored)
    explore_frac: float = 0.0625        # tracked-mode fraction of the swarm
                                        # re-seeded from the GLOBAL init
                                        # distribution each frame: a wrong
                                        # basin with competitive fitness
                                        # (measured r2: 13mm lock for 6
                                        # frames on the step object) can
                                        # always be recaptured without
                                        # waiting for watchdog collapse
    polish_accept_tol: float = 0.05     # final full-ICP polish acceptance
    polish_top_k: int = 8               # swarm candidates promoted to the
                                        # full-ICP polish + FINE-tier
                                        # scoring; basin selection happens
                                        # where discrimination is real
                                        # (coarse-tier best vs runner-up
                                        # gaps can be ~3%, measured r2)
    scan_render_subset: int = 512       # scoring samples for the coarse
                                        # basin-search tier (full set is
                                        # used at the fine tier)
    finish_iters: int = 4               # score-only annealed finisher stage
                                        # (3 -> 4 A/B r3: free in wall
                                        # time at the new ICP cadence,
                                        # trims the noisy-tail p90)
    finish_particles: int = 512         # finisher batch size (per shard)
    finish_sigma_frac: float = 0.15     # finisher start sigma (x rot/trans)
    finish_patch: int = 16              # px; per-point MXU gather patch
                                        # side for the finisher tier
                                        # (ops/gather_mxu.take_patch_*):
                                        # must cover the max projection
                                        # drift of a finisher candidate
                                        # from the pre-finisher best
                                        # (mm-scale sigmas -> a few px)
    finish_sigma_rungs: int = 4         # sigma scales per finisher batch:
                                        # particle i perturbs at
                                        # sigma_decay^(i%rungs); with
                                        # iters=3 x rungs=4 the ladder
                                        # covers the same 12 anneal scales
                                        # the old 12-iteration finisher
                                        # walked, in 3 large ops instead
                                        # of 12 small ones (the frame is
                                        # latency-bound: r2 finisher was
                                        # 37 ms of a 107 ms frame)
    slide_proposals: int = 8            # axial-slide candidates injected
                                        # into the fine-tier polish: copies
                                        # of the incumbent best translated
                                        # along the model's principal axis
                                        # by ±k/(n/2)*slide_max_frac of its
                                        # extent. The residual global-init
                                        # failures are full-coverage slides
                                        # along the elongation axis whose
                                        # hidden end sits behind the grasp
                                        # (measured: 28-50 mm on the 120 mm
                                        # box/cylinder) — the TRUE pose
                                        # out-scores them once reached, but
                                        # no swarm seed lands in its basin.
                                        # Sliding the converged estimate
                                        # directly probes the competing
                                        # translational basins; the full-ICP
                                        # polish + fine-tier argmax keeps
                                        # the winner. 0 disables.
    slide_max_frac: float = 0.48        # max slide offset as a fraction of
                                        # the model's principal-axis extent
                                        # (offsets step by max_frac/(n/2) ≈
                                        # the ICP capture radius)
    tie_break_eps: float = 0.0          # OPT-IN (default off — measured
                                        # NEGATIVE) continuity tie-break
                                        # at the fine-tier selection: among
                                        # candidates within eps*|best| of
                                        # the top fitness, pick the one
                                        # CLOSEST to the prior pose.
                                        # Measured r5 (box, noisy, level
                                        # 0, eps=0.01): ADD-S 1.72 ->
                                        # 2.13 mm, sym-aware ADD 2.64 ->
                                        # 4.28 mm — on flat geometry the
                                        # weak-DOF fitness gradient is
                                        # shallow, so a ~3°-drifted
                                        # incumbent stays inside any
                                        # useful tie window and the
                                        # tie-break SUPPRESSES the
                                        # argmax's drift-correcting
                                        # re-locks onto fresh crisp
                                        # candidates. Symmetry-twin
                                        # hopping (the problem this
                                        # targeted) is solved at zero
                                        # accuracy cost by the post-
                                        # selection symmetry-branch snap
                                        # instead (ops/pso.
                                        # snap_to_branch, default on).


@dataclass(frozen=True)
class ScoreConfig:
    """Render-and-compare scoring (SURVEY.md §3 "Render-and-compare scorer")."""
    depth_tau: float = 0.01             # meters; residual saturation scale
    depth_tau_fine: float = 0.0         # meters; optional separate
                                        # saturation scale for the FINE
                                        # tier (polish acceptance +
                                        # finisher). 0 = use depth_tau at
                                        # both tiers (default). Measured
                                        # (r3, VGA asym, 512p): 5 mm fine
                                        # tau degraded tracked ADD-S
                                        # 0.80 -> 1.22 mm — the sharper
                                        # kernel saturates while the
                                        # tracker is still multi-mm off
                                        # (init recovery), weakening
                                        # cross-candidate ranking exactly
                                        # when it matters; no gain under
                                        # 1 mm sensor noise either. Kept
                                        # as a knob for clean mm-regime
                                        # experiments.
    wrong_side_penalty: float = 2.0     # rendered in front of observed
    occlusion_margin: float = 0.005     # meters; hand-occlusion z-test margin
    coverage_weight: float = 0.5        # reward for explaining observed pixels
    invalid_penalty: float = 0.3        # rendered over no-return pixels
    scene_cov_weight: float = 0.5       # weight of the OBSERVATION-side
                                        # support term added to fitness:
                                        # w * (explained - 1) where
                                        # explained = weighted fraction
                                        # of scene points within
                                        # scene_cov_tau of the posed
                                        # model surface (ops/icp.py
                                        # scene_support). Projective
                                        # scoring alone never pays for
                                        # UNEXPLAINED observed points, so
                                        # a pose explaining half the
                                        # cloud and hiding the rest of
                                        # itself behind the hand-dropped
                                        # region can out-score truth
                                        # (measured r3: box slid 48 mm ->
                                        # fitness 1.455 vs truth 1.335;
                                        # support 0.57 vs 0.99). ~0 near
                                        # truth, so fitness scales
                                        # (watchdog thresholds) are
                                        # preserved. 0 disables.
    scene_cov_tau: float = 0.012        # meters; support distance. Must
                                        # exceed the ICP model-subset
                                        # point spacing (~8 mm at 512
                                        # samples on the test objects)
                                        # plus sensor noise
    mode: str = "point"                 # "point": projective association
                                        # (no per-particle z-buffer, the
                                        # fast path); "pixel": splat render
                                        # + per-pixel compare
    subpixel: bool = True               # fine scoring tier: edge-aware
                                        # bilinear observed-depth gather
                                        # (sub-pixel accuracy; point mode)
    ghost_dilate: int = 1               # px of silhouette tolerance before
                                        # a no-return projection is
                                        # penalized as a ghost
    gather_mode: str = "mxu"            # "mxu": projective depth lookups
                                        # as separable one-hot MXU
                                        # matmuls (ops/gather_mxu; XLA's
                                        # count-bound TPU gather was ~70%
                                        # of r2 frame latency); "take":
                                        # plain XLA gathers (oracle path)
    neutral_cov_exempt: bool = False    # exclude samples on segmentation-
                                        # dropped (_NEUTRAL) pixels from
                                        # the coverage denominator. The
                                        # estimator enables this for the
                                        # INIT program only: global
                                        # registration must not drag the
                                        # grasped true pose's coverage
                                        # for hand-hidden samples
                                        # (reduced-res box/cyl frame-0
                                        # init 19/20 -> 20/20), but in
                                        # TRACK mode the exemption forms
                                        # a mm-scale gradient toward the
                                        # hand region (asym noisy pinned
                                        # gate 1.8 -> >2.4 mm)
    self_occlusion: bool = True         # second-order visibility (track
                                        # program only): each render
                                        # sample's visibility is decided
                                        # ONCE per frame over the SEARCH
                                        # REGION (hypothesis priors +
                                        # self_occ_union sigma-perturbed
                                        # draws; splat + z-test, union —
                                        # estimator._search) and the
                                        # frame-constant [Nr] mask rides
                                        # through every scoring tier, so
                                        # front-facing samples hidden
                                        # behind another part of the SAME
                                        # object (concave geometry — mug
                                        # cavity, bracket web) stop
                                        # diluting fitness. Candidate-
                                        # independent by design: per-
                                        # candidate z-tests against an
                                        # incumbent map inject selection
                                        # noise (measured r5: fine-sigma
                                        # rank-vs-error tee 0.80 -> 0.68
                                        # per-pixel vs 0.80 -> 0.90
                                        # per-sample). Init keeps pure
                                        # back-face culling: global
                                        # candidates have no incumbent.
    self_occ_union: int = 6             # sigma-perturbed poses PER
                                        # hypothesis unioned into the
                                        # visibility test. An incumbent-
                                        # only mask (0 draws) culls
                                        # samples that rotate into view
                                        # under unpredicted motion and
                                        # biases every tier against the
                                        # moved true pose — measured r5
                                        # random-twist occlusion protocol,
                                        # convex box theta 30/50: 5.5/6.7
                                        # mm tracked mean incumbent-only
                                        # vs 1.6/1.7 mask-off; the union
                                        # keeps any sample visible
                                        # somewhere the swarm searches,
                                        # so only interior concavities
                                        # (hidden under EVERY nearby
                                        # pose) are culled.
    self_occ_count_floor: float = 0.5   # masked-fitness denominator floor
                                        # as a fraction of the UNMASKED
                                        # counted set (ops/score
                                        # compare_points): keeps far
                                        # candidates (explorer seeds, flip
                                        # hypotheses) from winning on the
                                        # sliver of samples the incumbent
                                        # mask leaves them — measured r5
                                        # tiny-config drive 4.8 -> 58.9 mm
                                        # without the floor (all-true-mask
                                        # plumbing pinned bitwise-neutral)
    self_occ_tan_max: float = 2.5       # samples whose view angle exceeds
                                        # atan(this) (~68 deg) at ANY
                                        # region pose are exempt from
                                        # culling: the splat footprint's
                                        # own-face depth spread grows as
                                        # tan(angle) and exceeds any
                                        # affordable margin there, so a
                                        # z-test cull is unreliable — and
                                        # culling edge-on faces opened a
                                        # lateral slide mode on flat
                                        # geometry (see self_occ_union;
                                        # box theta=50 6.6 -> measured
                                        # fix). Interior self-occlusion
                                        # is well-facing and unaffected.
    self_occ_margin: float = 0.008      # meters; z-test margin for the
                                        # incumbent visibility test. Must
                                        # absorb the splat footprint depth
                                        # bias on steep surfaces; measured
                                        # (r5, concave set, fine sigma):
                                        # 8 mm beats 12 mm (tee rank-vs-
                                        # error 0.90 vs 0.87) because the
                                        # tighter test removes more truly
                                        # hidden samples while the splat
                                        # bias stays ~1 lo-px lateral.


@dataclass(frozen=True)
class HandConfig:
    """Hand segmentation / occlusion parameters (SURVEY.md §3 L3)."""
    segment_dist: float = 0.008         # meters; point-to-hand distance removal
    full_res_mask: bool = True          # build the full-res hand drop
                                        # mask with its own VGA splat
                                        # (exact silhouette) vs nearest-
                                        # upsampling the lo-res occluder
                                        # splat (False): the VGA hand
                                        # scatter is the last big scatter
                                        # in the hot path (~4.3 ms of the
                                        # 34 ms frame incl. FK/config
                                        # scoring); the upsampled mask
                                        # quantizes the drop band to the
                                        # lo grid (~4 px) — the exact
                                        # point-level distance removal
                                        # still runs at full precision
                                        # either way. Kept as a measured
                                        # A/B knob (see SURVEY r5 notes).
    config_samples: int = 8             # sampled finger configurations
    config_select: int = 3              # keep the config_select sampled
                                        # configs that best agree with the
                                        # observed depth (projective score,
                                        # models/hand.config_agreement)
                                        # when building the drop/occluder
                                        # masks; 0 = blind union of all
                                        # samples (conservative: a wrong
                                        # nominal q silently over-drops
                                        # object evidence — VERDICT r2)
    joint_sigma: float = 0.12           # radians; actuation uncertainty
    base_refine_iters: int = 0          # >0: annealed render-space search
                                        # correcting the reported hand
                                        # BASE against the observed depth
                                        # before any mask is built — the
                                        # hand-mount calibration error the
                                        # joint-config sampling cannot
                                        # absorb (models/hand.refine_base)
    base_refine_candidates: int = 16    # sampled bases per search round
    base_refine_rot_sigma: float = 0.06  # radians; round-1 spread (annealed
                                         # x0.5/round; covers ~3 deg / ~25 mm
                                         # extrinsic error at 2 sigma)
    base_refine_trans_sigma: float = 0.012  # meters
    base_refine_auto: bool = True       # AUTO-ARM (VERDICT r4 item 5), in
                                        # the INIT/re-registration program
                                        # only: run the refinement search
                                        # and accept its winner ONLY when
                                        # the winner's observed-depth
                                        # agreement beats the reported
                                        # base's by base_refine_accept_
                                        # margin. An absolute agreement
                                        # threshold does NOT separate the
                                        # regimes (measured r5,
                                        # scripts/calibrate_base_agree.py:
                                        # calibrated scores -0.05..0.25
                                        # overlap miscalibrated
                                        # -0.20..0.24 — the absolute level
                                        # is scene-dominated), but the
                                        # GAIN does: calibrated bases gain
                                        # <= +0.059 (score-space splat-
                                        # floor overfit only), genuinely
                                        # miscalibrated ones gain
                                        # +0.084..+0.273. Calibrated
                                        # setups therefore keep the exact
                                        # reported base; miscalibrated
                                        # ones get the realistic-regime
                                        # init rate through ONE default
                                        # config. Track frames never pay
                                        # (the search lives in the init
                                        # program, whose cost it does not
                                        # measurably move); explicit
                                        # base_refine_iters > 0 still
                                        # refines unconditionally in BOTH
                                        # programs.
    base_refine_accept_margin: float = 0.08  # agreement gain above which
                                        # the refined base replaces the
                                        # reported one (see
                                        # base_refine_auto; measured gap:
                                        # calibrated max +0.059 vs
                                        # genuine-fix min +0.084)
    enabled: bool = True
    spec: str = "t42"                   # "t42" | "model_o" (procedural
                                        # built-ins) or a hand-spec YAML
                                        # path (models.load_hand_spec) for
                                        # real mesh assets


@dataclass(frozen=True)
class TrackerConfig:
    """Sequence tracking (BASELINE config 4)."""
    fitness_reinit_threshold: float = 0.25  # below -> global re-registration
    coverage_reinit_threshold: float = 0.05  # below -> re-registration even
                                            # at high fitness. Second line
                                            # of defense for the documented
                                            # drifted-but-confident mode
                                            # (score.py: a 71 mm-wrong pose
                                            # scored fitness 0.99 with
                                            # coverage 0.007 — fitness is a
                                            # per-counted-sample average, so
                                            # a pose that sheds evidence
                                            # pixels can stay "confident").
                                            # Healthy tracking coverage
                                            # measured 0.6-0.75 under a
                                            # T42 grasp (tiny + 160p
                                            # verify runs); 0.05 only
                                            # fires on collapse. 0 disables.
    reinit_particles: int = 1024
    reinit_rot_sigma: float = 3.2           # ~uniform rotations
    reinit_trans_sigma: float = 0.05
    n_hypotheses: int = 1                   # competing-basin hypotheses the
                                            # tracker carries across frames
                                            # (>1: the swarm splits among
                                            # them and fine-tier-distinct
                                            # basins persist; resolves
                                            # near-symmetry ambiguity as
                                            # soon as evidence separates)
    motion_prior: float = 0.0               # constant-velocity propagation:
                                            # > 0 seeds the tracked swarm
                                            # from BOTH the last pose and
                                            # exp(motion_prior * log(last
                                            # frame-to-frame delta)) @ last
                                            # (exact for constant rigid
                                            # motion). Default OFF by
                                            # measurement (r3): the PSO+ICP
                                            # capture range absorbs 28 deg
                                            # + 45 mm per frame without it,
                                            # and during init recovery the
                                            # delta folds mm-scale
                                            # estimation residuals into a
                                            # spurious "velocity" (clean
                                            # VGA tracked ADD-S 0.80 ->
                                            # 0.91 mm). Knob for regimes
                                            # with a weakened per-frame
                                            # search (low iters/particles).
                                            # Applied when n_hypotheses==1.
    reinit_icp_iters_inner: int = 2         # in-scan NN searches per PSO
                                            # iteration for the INIT
                                            # program (track mode: see
                                            # PsoConfig.icp_iters_inner).
                                            # r3's track cadence cut
                                            # (1 search x 3 reps, model
                                            # subset 256) costs basin-
                                            # capture strength exactly
                                            # where it matters most —
                                            # global registration ranks
                                            # basins tens of mm apart —
                                            # and init runs once per
                                            # (re-)registration, so the
                                            # heavier pull is amortized
    reinit_icp_model_subset: int = 512      # inner-ICP model points for
                                            # the init program
    reinit_prescreen: int = 4096            # orientations scored ONCE
                                            # (no ICP) before the global
                                            # search; top reinit_particles
                                            # seed the swarm. ~13 deg
                                            # orientation gaps at 4096 vs
                                            # ~20 deg at 1024 — decides
                                            # whether the true basin is
                                            # visited at all. 0 = off.
    prescreen_support: int = 256            # top prescreen candidates that
                                            # additionally get the
                                            # observation-side scene-
                                            # support term (one batched NN
                                            # on the inner-ICP subsets);
                                            # the top-half swarm seeds are
                                            # then picked WITHIN this
                                            # corrected subset (clamped to
                                            # >= particles, i.e. 2x the
                                            # top-half count — see the
                                            # measured mixing hazard in
                                            # estimator.py). The raw
                                            # projective ranking never
                                            # pays for unexplained
                                            # observed points, so its top
                                            # can be dominated by slid/
                                            # flipped candidates (measured
                                            # r3: fitness 1.455 for a
                                            # 48 mm slide vs 1.335 at
                                            # truth). 0 = off.


@dataclass(frozen=True)
class EstimatorConfig:
    camera: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    icp: IcpConfig = field(default_factory=IcpConfig)
    pso: PsoConfig = field(default_factory=PsoConfig)
    score: ScoreConfig = field(default_factory=ScoreConfig)
    hand: HandConfig = field(default_factory=HandConfig)
    tracker: TrackerConfig = field(default_factory=TrackerConfig)
    scene_points: int = 2048            # fixed-size subsampled scene cloud
    model_points: int = 1024            # fixed-size model cloud
    render_size: int = 120              # coarse scoring tier height for the
                                        # PSO basin search; polish + finisher
                                        # always score at full camera res
                                        # (two-tier, ops/pso.py)
    depth_min: float = 0.1              # meters; valid depth gate
    depth_max: float = 2.0
    outlier_tau: float = 0.02           # grid statistical outlier removal
                                        # (ops/preprocess.speckle_mask):
                                        # pixels with < outlier_min_neighbors
                                        # 8-neighbors within tau meters are
                                        # dropped as speckle. 0 disables.
    outlier_min_neighbors: int = 2
    dtype: str = "float32"


def _build(cls, data: Mapping[str, Any]):
    names = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in data.items():
        if k not in names:
            raise KeyError(f"unknown config key {k!r} for {cls.__name__}")
        ftype = names[k].type
        if isinstance(v, Mapping):
            sub = {
                "camera": CameraIntrinsics, "icp": IcpConfig, "pso": PsoConfig,
                "score": ScoreConfig, "hand": HandConfig, "tracker": TrackerConfig,
            }[k]
            kwargs[k] = _build(sub, v)
        else:
            kwargs[k] = v
    return cls(**kwargs)


def load_yaml(path: str) -> EstimatorConfig:
    """Load an EstimatorConfig from a YAML file (reference config.yaml shape)."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    return _build(EstimatorConfig, data)


def save_yaml(cfg: EstimatorConfig, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(dataclasses.asdict(cfg), f)
