"""The reference's accuracy gates as cases of the port: one function per
test of the six statistical test files of the JAX package
(`test_occlusion_gate.py`, `test_accuracy_regression.py`,
`test_realistic_regression.py`, `test_base_refine_auto.py`,
`test_init_success.py`, `test_score_concave.py::test_tracking_concave_mug`).

Not a test file (pytest does not collect it). It imports neither jax nor the
JAX package: `tests/test_torch_gate_*.py` run the cases on the CPU,
`chip_smoke.py` phase 17 runs every case on the card over seeds, and
`tests/port_gate_parity.py` runs the same scenario code with the JAX package
plugged in (its `JaxBackend` and `JaxDraws`) to measure the reference's own
pass rates.

Each case function builds its reference test's scenario with the reference's
exact configuration (camera, `PsoConfig`, `TrackerConfig`, point counts,
meshes, `noise_sigma`, the numpy seeds), runs the estimator or tracker and
returns a `Result`: the statistics the reference asserts on and `passed`,
the reference test's assertions evaluated with its thresholds, unchanged.

Seeds. `seed` offsets every integer from which the reference makes a
`jax.random` key (`key(97)` -> 97 + seed, `split(key(0), N)` -> base 0 +
seed, `Tracker(est, seed=0)` -> seed); the numpy scene draws stay the
reference's. The draws the reference takes from `jax.random` (trial
orientations, recovery and path perturbations) come from a `draws` object:
`PortDraws` (the default) computes them with the port's `se3` on a host
`torch.Generator` seeded from the same integers, the way
`benchmarks._fold` folds (seed, trial, tag); a test passes the reference's
own draws in instead. `seed = 0` with the reference's draws injected is the
reference test's own scenario. The estimator's own stream is the port's:
`Tracker(est, seed=base)`, and an init frame's key `_fold(base, trial, 0)`
(a recovery frame's `_fold(base, trial, 3)`), as `benchmarks.bench_init`
keys them.
"""
from __future__ import annotations

import dataclasses as dc
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

# the reference files' cameras: 320 x 240 (five files), 160 x 120
# (test_score_concave.py)
CAM = dict(width=320, height=240, fx=285.0, fy=285.0, cx=160.0, cy=120.0)
CAM_SMALL = dict(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)
HQ = (0.45, 0.45)


def _fold(seed: int, trial: int, tag: int) -> int:
    """An integer seed for draw `tag` of trial `trial` (the reference's
    fold_in(split(key(seed))[trial], tag)); `benchmarks._fold`'s rule."""
    return int(np.random.SeedSequence([seed, trial, tag]).generate_state(1)[0])


# ---------------------------------------------------------------------------
# Random draws that the reference takes from jax.random
# ---------------------------------------------------------------------------

class PortDraws:
    """The port's draws: `se3` on a host torch.Generator. `base` is the
    reference's key integer plus the seed, `n` the reference's split count
    (unused here), `tag` its fold_in tag."""

    @staticmethod
    def _gen(seed: int) -> torch.Generator:
        return torch.Generator(device="cpu").manual_seed(seed)

    def rotation(self, base: int, n: int, t: int, tag: int) -> np.ndarray:
        from icra20_hand_object_pose_tpu_torch.utils import se3

        return se3.random_rotation(self._gen(_fold(base, t, tag))).numpy()

    def perturb(self, base: int, n: int, t: int, tag: int, pose, rot_sigma: float,
                trans_sigma: float) -> np.ndarray:
        from icra20_hand_object_pose_tpu_torch.utils import se3

        return se3.perturb_pose(
            self._gen(_fold(base, t, tag)), torch.as_tensor(np.asarray(pose, np.float32)),
            rot_sigma, trans_sigma).numpy().astype(np.float32)

    def path(self, base: int, pose, n_frames: int, rot_sigma: float,
             trans_sigma: float) -> list[np.ndarray]:
        """n_frames object poses from `pose`, each a perturbation of the
        last (the reference splits `key(base)` once a frame)."""
        from icra20_hand_object_pose_tpu_torch.utils import se3

        gen = self._gen(base)
        out = [np.asarray(pose, np.float32)]
        for _ in range(1, n_frames):
            out.append(se3.perturb_pose(gen, torch.as_tensor(out[-1]), rot_sigma,
                                        trans_sigma).numpy().astype(np.float32))
        return out


# ---------------------------------------------------------------------------
# The package under test
# ---------------------------------------------------------------------------

class PortBackend:
    """The port's entry points on `device`, with the models each case needs
    built once (a card run reuses them over seeds)."""

    def __init__(self, device="cuda"):
        from icra20_hand_object_pose_tpu_torch import datasets, evaluation, models
        from icra20_hand_object_pose_tpu_torch.utils import config, meshio, se3

        self.device = torch.device(device)
        self.datasets, self.models, self.config = datasets, models, config
        self.meshio, self._se3, self.evaluation = meshio, se3, evaluation
        self._cache: dict = {}

    def _cached(self, key, make):
        if key not in self._cache:
            self._cache[key] = make()
        return self._cache[key]

    def hand(self, **kw):
        return self._cached(("hand", tuple(sorted(kw.items()))),
                            lambda: self.models.make_t42_hand(device=self.device, **kw))

    def object(self, mesh, shape: str, **kw):
        return self._cached(("obj", shape, tuple(sorted(kw.items()))),
                            lambda: self.models.ObjectModel(mesh, device=self.device, **kw))

    def estimator(self, obj, hand, cfg):
        return self._cached(("est", id(obj), id(hand), repr(cfg)),
                            lambda: self.models.Estimator(obj, hand, cfg))

    def render_frame(self, *args, **kw) -> np.ndarray:
        return self.datasets.render_frame(*args, device=self.device, **kw)

    def generate_sequence(self, mesh, hand, seq_cfg):
        return self.datasets.generate_sequence(mesh, hand, seq_cfg, device=self.device)

    def se3_exp(self, xi: np.ndarray) -> np.ndarray:
        return self._se3.se3_exp(torch.as_tensor(np.asarray(xi, np.float32))).numpy()

    def tracker(self, est, seed: int):
        return self.models.Tracker(est, seed=seed)

    @staticmethod
    def start_from(tracker, pose) -> None:
        """Seed the tracker with a known pose (the reference's
        `_replace(pose=..., initialized=True, fitness=1.0)`)."""
        tracker.state = tracker.state._replace(
            pose=tracker.est._tensor(pose), initialized=True, fitness=1.0)

    @staticmethod
    def step(tracker, depth, hand_base, hand_q) -> tuple[np.ndarray, float, bool]:
        res = tracker.step(depth, hand_base, hand_q)
        return res.pose.cpu().numpy(), float(res.coverage), bool(res.reinitialized)

    @staticmethod
    def estimate(est, depth, prior, hand_base, hand_q, key, mode: str):
        return est.estimate(depth, prior, hand_base, hand_q, key=key, mode=mode).pose

    @staticmethod
    def to_numpy(pose) -> np.ndarray:
        return pose.cpu().numpy()

    @staticmethod
    def key(base: int, n: int, t: int, tag: int | None):
        """The estimator's key for trial t: the reference's keys[t] (tag
        None) or fold_in(keys[t], tag)."""
        return _fold(base, t, 0 if tag is None else tag)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

class Check(NamedTuple):
    """One assertion of the reference test: stats[stat] <op> limit."""
    stat: str
    op: str          # "<", ">" or ">="
    limit: float

    def holds(self, value: float, limit: float | None = None) -> bool:
        lim = self.limit if limit is None else limit
        return {"<": value < lim, ">": value > lim, ">=": value >= lim}[self.op]

    def worse(self, a: float, b: float) -> float:
        """The worse of two values of this statistic."""
        return max(a, b) if self.op == "<" else min(a, b)


class Result(NamedTuple):
    case: str
    seed: int
    stats: dict          # statistic -> value (the checks' and per-frame lists)
    checks: list         # [Check]
    passed: bool
    seconds: float

    def message(self) -> str:
        return (f"{self.case} seed {self.seed}: "
                + ", ".join(f"{c.stat} {self.stats[c.stat]:.4g} {c.op} {c.limit:.4g}"
                            f" {'ok' if c.holds(self.stats[c.stat]) else 'FAILED'}"
                            for c in self.checks)
                + f"; {self.stats}")


def _result(case, seed, stats, checks, t0) -> Result:
    return Result(case, seed, stats, checks,
                  all(c.holds(stats[c.stat]) for c in checks),
                  time.perf_counter() - t0)


def _mm(errs) -> list[float]:
    return [1000.0 * float(e) for e in errs]


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

class Frame(NamedTuple):
    """One frame as the estimator receives it, and its ground truth."""
    depth: np.ndarray
    hand_base: np.ndarray      # the reported base (what the estimator gets)
    hand_q: np.ndarray         # the nominal joint values it gets
    pose_gt: np.ndarray


def _cfg(c, cam=CAM, **kw):
    """An EstimatorConfig of the config module `c` at the files' 320 x 240
    camera, 1024 scene points and 256 particles x 10 iterations."""
    return c.EstimatorConfig(camera=c.CameraIntrinsics(**cam), scene_points=1024,
                             pso=c.PsoConfig(particles=256, iters=10), **kw)


def _gate_cfg(c, **kw):
    """The configuration shared by four of the files: `_cfg` with 512 re-init
    particles."""
    return _cfg(c, tracker=c.TrackerConfig(reinit_particles=512), **kw)


def _calibration_error(B, rng: np.random.Generator) -> np.ndarray:
    """The reference's hand-mount error: 3 degrees about and 5 mm along
    random unit axes, drawn from `rng` (normals, rotation first)."""
    w = rng.normal(size=3)
    w = w / np.linalg.norm(w) * np.radians(3.0)
    v = rng.normal(size=3)
    v = v / np.linalg.norm(v) * 5e-3
    return B.se3_exp(np.concatenate([w, v]))


def frontal_grasp_base(object_pose, theta_deg, offset=0.10):
    """Grasp approach rotated toward the camera (test_occlusion_gate.py):
    theta=78 puts palm + both fingers between camera and object."""
    T = np.asarray(object_pose, np.float32)
    c = T[:3, 3]
    th = np.radians(theta_deg)
    z_h = np.array([np.cos(th), 0.0, np.sin(th)], np.float32)
    y_h = np.array([0.0, 1.0, 0.0], np.float32)
    x_h = np.cross(y_h, z_h).astype(np.float32)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = np.stack([x_h, y_h, z_h], axis=1)
    out[:3, 3] = c - z_h * offset
    return out


# (level name, theta_deg [0 = side grasp], realistic, max ADD-S mm):
# test_occlusion_gate.py LEVELS
LEVELS = [
    ("low_18pct", 0.0, False, 6.0),
    ("mid_47pct", 50.0, False, 6.0),
    ("heavy_63pct", 78.0, False, 8.0),
    ("realistic_heavy", 78.0, True, 10.0),
]


def occlusion_scenario(B, draws, level: str, seed: int = 0) -> list[Frame]:
    """test_occlusion_gate.py: 4 frames of the asym object under a grasp at
    `level`, the object moving 0.05 rad / 4 mm a frame from a key-split
    chain (key 97)."""
    _, theta, realistic, _ = next(lv for lv in LEVELS if lv[0] == level)
    mesh = B.meshio.make_test_object("asym")
    hand = B.hand()
    hq = np.asarray(HQ, np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [0.0, 0.0, 0.5]
    hb = frontal_grasp_base(pose, theta) if theta > 0 else B.datasets.hand_base_for_grasp(pose)
    q_true, sensor, base_err = hq, None, np.eye(4, dtype=np.float32)
    if realistic:
        sensor = B.datasets.SensorModel()
        base_err = _calibration_error(B, np.random.default_rng(41))
        q_true = (hq + 0.15).astype(np.float32)
    cam = B.config.CameraIntrinsics(**CAM)
    rng = np.random.default_rng(7000)
    path = draws.path(97 + seed, pose, 4, 0.05, 0.004)
    frames, cur = [], pose
    for f, nxt in enumerate(path):
        if f > 0:
            hb = (nxt @ np.linalg.inv(cur) @ hb).astype(np.float32)
            cur = nxt
        dep = B.render_frame(mesh, cur, hand, hb, q_true, cam,
                             noise_sigma=0.001, rng=rng, sensor=sensor)
        frames.append(Frame(dep, (base_err @ hb).astype(np.float32), hq, cur))
    return frames


def occlusion(level: str, seed: int = 0, device="cuda", *, backend=None,
              draws=None) -> Result:
    """test_occlusion_gate.py::test_tracking_under_occlusion[level]: the
    non-realistic levels track from the true pose; realistic_heavy starts
    cold (frame 0 is a global init with the auto-armed base refinement).
    Asserts max tracked ADD-S (frames 1-3) < the level's gate and every
    frame's coverage above the re-init threshold."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    t0 = time.perf_counter()
    _, _, realistic, gate_mm = next(lv for lv in LEVELS if lv[0] == level)
    cfg = _gate_cfg(B.config)
    mesh = B.meshio.make_test_object("asym")
    obj = B.object(mesh, "asym", model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), cfg)
    dense, _ = mesh.sample_surface(8192, seed=123)
    frames = occlusion_scenario(B, draws, level, seed)
    tracker = B.tracker(est, seed)
    if not realistic:
        B.start_from(tracker, frames[0].pose_gt)
    errs, covs, reinit = [], [], []
    for f, fr in enumerate(frames):
        pose, cov, re = B.step(tracker, fr.depth, fr.hand_base, fr.hand_q)
        covs.append(cov)
        reinit.append(re)
        if f > 0:
            errs.append(B.evaluation.add_s_error(pose, fr.pose_gt, dense))
    stats = {"max_adds_mm": max(_mm(errs)), "min_coverage": min(covs),
             "adds_mm": _mm(errs), "coverage": covs, "reinitialized": reinit}
    checks = [Check("max_adds_mm", "<", gate_mm),
              Check("min_coverage", ">", cfg.tracker.coverage_reinit_threshold)]
    return _result(f"test_occlusion_gate.py::test_tracking_under_occlusion[{level}]",
                   seed, stats, checks, t0)


# test_accuracy_regression.py: mean dense-cloud ADD-S thresholds (meters)
ACCURACY_THRESHOLDS = {
    ("asym", False): 1.4e-3,
    ("asym", True): 2.4e-3,
    ("mug", True): 3.5e-3,
}
WORST_FRAME = 8e-3


def accuracy_sequence(B, shape: str, noise: bool):
    """test_accuracy_regression.py's 4-frame sequence (seed 3)."""
    mesh = B.meshio.make_test_object(shape)
    return B.generate_sequence(mesh, B.hand(), B.datasets.SyntheticSequenceConfig(
        n_frames=4, camera=B.config.CameraIntrinsics(**CAM),
        noise_sigma=0.001 if noise else 0.0, dropout=0.02 if noise else 0.0, seed=3))


def accuracy(shape: str, noise: bool, seed: int = 0, device="cuda", *,
             backend=None, draws=None) -> Result:
    """test_accuracy_regression.py::test_tracked_adds_pinned[shape-noise]:
    4 frames tracked from the first ground truth (default ObjectModel
    sizes, default TrackerConfig); asserts the mean ADD-S under its pinned
    threshold and every frame under 8 mm."""
    B = backend or PortBackend(device)
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object(shape)
    est = B.estimator(B.object(mesh, shape), B.hand(), _cfg(B.config))
    seq = accuracy_sequence(B, shape, noise)
    tracker = B.tracker(est, seed)
    B.start_from(tracker, seq[0].pose_gt)
    dense, _ = mesh.sample_surface(8192, seed=123)
    errs = [B.evaluation.add_s_error(B.step(tracker, fr.depth, fr.hand_base, fr.hand_q)[0],
                                     fr.pose_gt, dense) for fr in seq]
    stats = {"mean_adds_mm": float(np.mean(_mm(errs))), "max_adds_mm": max(_mm(errs)),
             "adds_mm": _mm(errs)}
    checks = [Check("mean_adds_mm", "<", 1000.0 * ACCURACY_THRESHOLDS[(shape, noise)]),
              Check("max_adds_mm", "<", 1000.0 * WORST_FRAME)]
    return _result(f"test_accuracy_regression.py::test_tracked_adds_pinned[{shape}-{noise}]",
                   seed, stats, checks, t0)


REALISTIC_FINAL_MM = {"ellipsoid": 5.0, "asym": 7.0}


def realistic_sequence(B, shape: str):
    """test_realistic_regression.py's 3-frame sequence under the realistic
    sensor with the hand-mount error (seed 3)."""
    mesh = B.meshio.make_test_object(shape)
    return B.generate_sequence(mesh, B.hand(), B.datasets.SyntheticSequenceConfig(
        n_frames=3, camera=B.config.CameraIntrinsics(**CAM),
        sensor=B.datasets.SensorModel(), hand_base_err_mm=5.0, hand_base_err_deg=3.0,
        hand_q_true_offset=0.15, seed=3))


def _track_realistic(B, shape, cfg, seed):
    mesh = B.meshio.make_test_object(shape)
    obj = B.object(mesh, shape, model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), cfg)
    dense, _ = mesh.sample_surface(8192, seed=123)
    seq = realistic_sequence(B, shape)
    tracker = B.tracker(est, seed)
    B.start_from(tracker, seq[0].pose_gt)
    errs, covs = [], []
    for fr in seq:
        pose, cov, _ = B.step(tracker, fr.depth, fr.hand_base, fr.hand_q)
        errs.append(B.evaluation.add_s_error(pose, fr.pose_gt, dense))
        covs.append(cov)
    return _mm(errs), covs


def realistic_tracking(shape: str, seed: int = 0, device="cuda", *, backend=None,
                       draws=None) -> Result:
    """test_realistic_regression.py::test_realistic_tracking[shape-final]:
    the last frame's ADD-S under the shape's limit and no coverage
    watchdog misfire."""
    B = backend or PortBackend(device)
    t0 = time.perf_counter()
    cfg = _gate_cfg(B.config)
    errs, covs = _track_realistic(B, shape, cfg, seed)
    stats = {"final_adds_mm": errs[-1], "min_coverage": min(covs), "adds_mm": errs,
             "coverage": covs}
    final = REALISTIC_FINAL_MM[shape]
    checks = [Check("final_adds_mm", "<", final),
              Check("min_coverage", ">", cfg.tracker.coverage_reinit_threshold)]
    return _result(f"test_realistic_regression.py::test_realistic_tracking[{shape}-{final}]",
                   seed, stats, checks, t0)


def base_refine_excursion(seed: int = 0, device="cuda", *, backend=None,
                          draws=None) -> Result:
    """test_realistic_regression.py::
    test_realistic_tracking_base_refine_removes_excursion: asym's realistic
    sequence with HandConfig(base_refine_iters=3), every frame < 8 mm."""
    B = backend or PortBackend(device)
    t0 = time.perf_counter()
    cfg = _gate_cfg(B.config, hand=B.config.HandConfig(base_refine_iters=3))
    errs, _ = _track_realistic(B, "asym", cfg, seed)
    stats = {"max_adds_mm": max(errs), "adds_mm": errs}
    return _result("test_realistic_regression.py::"
                   "test_realistic_tracking_base_refine_removes_excursion",
                   seed, stats, [Check("max_adds_mm", "<", 8.0)], t0)


def sensor_model_properties(seed: int = 0, device="cuda", *, backend=None,
                            draws=None) -> Result:
    """test_realistic_regression.py::test_sensor_model_properties: the
    sensor model's quantization, z^2 noise growth and edge jitter on a
    64 x 64 depth step. Numpy only: every seed draws the same."""
    B = backend or PortBackend(device)
    t0 = time.perf_counter()
    SM, apply = B.datasets.SensorModel, B.datasets.apply_sensor_model
    d = np.full((64, 64), 0.5, np.float32)
    d[:, 32:] = 1.0
    out = apply(d, SM(noise_sigma=0.0, quantize=0.001, edge_sigma_px=0.0, dropout=0.0),
                np.random.default_rng(0))
    quantized = bool(np.allclose(out * 1000, np.round(out * 1000)))
    out = apply(d, SM(noise_sigma=0.002, quantize=0.0, edge_sigma_px=0.0, dropout=0.0),
                np.random.default_rng(1))
    ratio = float(np.std(out[:, 32:] - 1.0) / np.std(out[:, :32] - 0.5))
    out = apply(d, SM(noise_sigma=0.0, quantize=0.0, edge_sigma_px=0.7, dropout=0.0),
                np.random.default_rng(2))
    flat = bool(np.allclose(out[:, :16], 0.5))
    moved = bool(np.any(out[:, 31:33] != d[:, 31:33]))
    stats = {"quantized": float(quantized), "noise_ratio": ratio,
             "interior_flat": float(flat), "edge_moved": float(moved)}
    checks = [Check("quantized", ">=", 1.0), Check("noise_ratio", ">", 2.5),
              Check("noise_ratio", "<", 6.0), Check("interior_flat", ">=", 1.0),
              Check("edge_moved", ">=", 1.0)]
    return _result("test_realistic_regression.py::test_sensor_model_properties",
                   seed, stats, checks, t0)


# --- init trials -------------------------------------------------------------

class Trial(NamedTuple):
    """One init trial: the frame, a callable that renders the
    one-tracked-frame recovery view (None where the test gives no recovery
    credit), and the trial's key (base, split count, index)."""
    frame: Frame
    recovery: Callable[[], Frame] | None
    key: tuple


def _init_trials(B, draws, *, shape, base, n, trials, gt_translation,
                 calibration=None, noise=0.001, sensor=None, render_seed=1000,
                 recovery=True) -> list[Trial]:
    """The init tests' shared trial loop: orientation from
    rotation(keys[t], tag 1), translation from `gt_translation(t)`, the
    side grasp, an optional hand-mount error (`calibration(t)` -> (hb error,
    q offset)), the frame rendered with numpy seed render_seed + t, and the
    recovery view (perturbation fold_in(keys[t], 2), numpy seed 2000 + t)."""
    mesh = B.meshio.make_test_object(shape)
    hand = B.hand()
    cam = B.config.CameraIntrinsics(**CAM)
    hq = np.asarray(HQ, np.float32)
    out = []
    for t in trials:
        gt = np.eye(4, dtype=np.float32)
        gt[:3, :3] = draws.rotation(base, n, t, 1)
        gt[:3, 3] = gt_translation(t)
        hb = B.datasets.hand_base_for_grasp(gt)
        hb_rep, q_true = hb, hq
        if calibration is not None:
            err_T, dq = calibration(t)
            hb_rep = (err_T @ hb).astype(np.float32)
            q_true = (hq + dq).astype(np.float32)
        depth = B.render_frame(mesh, gt, hand, hb, q_true, cam, noise_sigma=noise,
                               rng=np.random.default_rng(render_seed + t), sensor=sensor)

        def view(t=t, gt=gt, hb=hb, hb_rep=hb_rep, q_true=q_true):
            p1 = draws.perturb(base, n, t, 2, gt, 0.035, 0.002)
            move = p1 @ np.linalg.inv(gt)
            d1 = B.render_frame(mesh, p1, hand, (move @ hb).astype(np.float32), q_true,
                                cam, noise_sigma=noise,
                                rng=np.random.default_rng(2000 + t), sensor=sensor)
            return Frame(d1, (move @ hb_rep).astype(np.float32), hq, p1)

        out.append(Trial(Frame(depth, hb_rep, hq, gt), view if recovery else None,
                         (base, n, t)))
    return out


def _run_trials(B, est, trials, base, n, dense, limit_m):
    """Init each trial (key keys[t]); a miss gets one tracked recovery frame
    (key fold_in(keys[t], 3)) when the trial has one. Returns the success
    count and each trial's frame-0 and final ADD-S (m)."""
    n_ok, errs0, errs = 0, [], []
    for t, tr in trials:
        fr = tr.frame
        out = B.estimate(est, fr.depth, np.eye(4, dtype=np.float32), fr.hand_base,
                         fr.hand_q, B.key(base, n, t, None), "init")
        e = B.evaluation.add_s_error(B.to_numpy(out), fr.pose_gt, dense)
        errs0.append(e)
        if e >= limit_m and tr.recovery is not None:
            f1 = tr.recovery()
            out1 = B.estimate(est, f1.depth, out, f1.hand_base, f1.hand_q,
                              B.key(base, n, t, 3), "track")
            e = B.evaluation.add_s_error(B.to_numpy(out1), f1.pose_gt, dense)
        errs.append(e)
        n_ok += int(e < limit_m)
    return n_ok, _mm(errs0), _mm(errs)


def realistic_init_trials(B, draws, shape: str, seed: int = 0) -> list[Trial]:
    """test_realistic_regression.py::test_realistic_init's 4 trials (keys
    split(key(0), 4), numpy 0 / 7000 + t / 1000 + t)."""
    rng = np.random.default_rng(0)

    def calibration(t):
        cal = np.random.default_rng(7000 + t)
        err_T = _calibration_error(B, cal)
        return err_T, cal.choice([-0.15, 0.15])

    return _init_trials(
        B, draws, shape=shape, base=0 + seed, n=4, trials=range(4),
        gt_translation=lambda t: [rng.uniform(-0.06, 0.06), rng.uniform(-0.05, 0.05),
                                  rng.uniform(0.40, 0.60)],
        calibration=calibration, noise=0.0, sensor=B.datasets.SensorModel())


def realistic_init(shape: str, seed: int = 0, device="cuda", *, backend=None,
                   draws=None) -> Result:
    """test_realistic_regression.py::test_realistic_init[shape]: >= 3 of 4
    inits under the realistic model (one tracked recovery frame counts)."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object(shape)
    obj = B.object(mesh, shape, model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), _gate_cfg(B.config))
    dense, _ = mesh.sample_surface(8192, seed=123)
    trials = realistic_init_trials(B, draws, shape, seed)
    n_ok, e0, e = _run_trials(B, est, enumerate(trials), 0 + seed, 4, dense,
                              0.1 * obj.diameter)
    stats = {"n_ok": float(n_ok), "init_adds_mm": e0, "adds_mm": e}
    return _result(f"test_realistic_regression.py::test_realistic_init[{shape}]",
                   seed, stats, [Check("n_ok", ">=", 3.0)], t0)


def base_refine_trials(B, draws, realistic: bool, seed: int = 0) -> list[Trial]:
    """test_base_refine_auto.py's 4 trials (keys split(key(11), 4), numpy
    5 / 900 + t / 70 + t); no recovery credit."""
    rng = np.random.default_rng(5)

    def calibration(t):
        cal = np.random.default_rng(900 + t)
        err_T = _calibration_error(B, cal)
        return err_T, cal.choice([-0.15, 0.15])

    return _init_trials(
        B, draws, shape="asym", base=11 + seed, n=4, trials=range(4),
        gt_translation=lambda t: [rng.uniform(-0.05, 0.05), rng.uniform(-0.04, 0.04),
                                  rng.uniform(0.42, 0.55)],
        calibration=calibration if realistic else None,
        noise=0.0 if realistic else 0.001,
        sensor=B.datasets.SensorModel() if realistic else None,
        render_seed=70, recovery=False)


def base_refine_auto(realistic: bool, seed: int = 0, device="cuda", *, backend=None,
                     draws=None) -> Result:
    """test_base_refine_auto.py: the one default config in the calibrated
    regime (all 4 inits succeed) or the miscalibrated one (>= 3 of 4)."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object("asym")
    obj = B.object(mesh, "asym", model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), _gate_cfg(B.config))
    dense, _ = mesh.sample_surface(4096, seed=123)
    trials = base_refine_trials(B, draws, realistic, seed)
    n_ok, e0, _ = _run_trials(B, est, enumerate(trials), 11 + seed, 4, dense,
                              0.1 * obj.diameter)
    name = "miscalibrated" if realistic else "calibrated"
    return _result(f"test_base_refine_auto.py::test_default_config_{name}_regime", seed,
                   {"n_ok": float(n_ok), "adds_mm": e0},
                   [Check("n_ok", ">=", 3.0 if realistic else 4.0)], t0)


INIT_MIN_OK = {"ellipsoid": 4, "asym": 4}


def init_success_trials(B, draws, shape: str, seed: int = 0) -> list[Trial]:
    """test_init_success.py::test_global_init_success's 5 trials (keys
    split(key(0), 5), numpy 0 / 1000 + t / 2000 + t)."""
    rng = np.random.default_rng(0)
    return _init_trials(
        B, draws, shape=shape, base=0 + seed, n=5, trials=range(5),
        gt_translation=lambda t: [rng.uniform(-0.06, 0.06), rng.uniform(-0.05, 0.05),
                                  rng.uniform(0.40, 0.60)])


def init_success(shape: str, seed: int = 0, device="cuda", *, backend=None,
                 draws=None) -> Result:
    """test_init_success.py::test_global_init_success[shape-min_ok]: >= 4
    of 5 global inits (one tracked recovery frame counts)."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object(shape)
    obj = B.object(mesh, shape, model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), _gate_cfg(B.config))
    dense, _ = mesh.sample_surface(8192, seed=123)
    trials = init_success_trials(B, draws, shape, seed)
    n_ok, e0, e = _run_trials(B, est, enumerate(trials), 0 + seed, 5, dense,
                              0.1 * obj.diameter)
    min_ok = INIT_MIN_OK[shape]
    return _result(f"test_init_success.py::test_global_init_success[{shape}-{min_ok}]",
                   seed, {"n_ok": float(n_ok), "init_adds_mm": e0, "adds_mm": e},
                   [Check("n_ok", ">=", float(min_ok))], t0)


SLIDE_TRIAL = 17


def slide_trial(B, draws, shape: str, seed: int = 0) -> Trial:
    """test_init_success.py::test_grasp_occluded_slide_case's trial 17 (keys
    split(key(0), 20), translation from the 18th row of numpy 0's uniforms,
    render seed 1017); no recovery credit."""
    draws_u = np.random.default_rng(0).uniform(size=(SLIDE_TRIAL + 1, 3))
    u = draws_u[SLIDE_TRIAL]
    return _init_trials(
        B, draws, shape=shape, base=0 + seed, n=20, trials=[SLIDE_TRIAL],
        gt_translation=lambda t: [-0.06 + 0.12 * u[0], -0.05 + 0.10 * u[1],
                                  0.40 + 0.20 * u[2]],
        recovery=False)[0]


def slide_case(shape: str, seed: int = 0, device="cuda", *, backend=None,
               draws=None) -> Result:
    """test_init_success.py::test_grasp_occluded_slide_case[shape-17]: the
    frame-0 init within 10% of the diameter."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object(shape)
    obj = B.object(mesh, shape, model_points=1024, render_points=1024)
    est = B.estimator(obj, B.hand(), _gate_cfg(B.config))
    dense, _ = mesh.sample_surface(8192, seed=123)
    trial = slide_trial(B, draws, shape, seed)
    _, e0, _ = _run_trials(B, est, [(SLIDE_TRIAL, trial)], 0 + seed, 20, dense,
                           0.1 * obj.diameter)
    return _result(f"test_init_success.py::test_grasp_occluded_slide_case[{shape}-{SLIDE_TRIAL}]",
                   seed, {"adds_mm": e0[0]},
                   [Check("adds_mm", "<", 100.0 * obj.diameter)], t0)


def concave_mug_cfg(c):
    """test_score_concave.py::test_tracking_concave_mug's configuration (`c`
    the config module)."""
    return c.EstimatorConfig(
        camera=c.CameraIntrinsics(**CAM_SMALL),
        icp=c.IcpConfig(iters=10, max_corresp_dist=0.05),
        pso=c.PsoConfig(particles=32, iters=4, rot_sigma=0.10, trans_sigma=0.012,
                        icp_every=1, icp_iters_inner=4, elite_frac=0.25),
        hand=c.HandConfig(config_samples=4),
        tracker=c.TrackerConfig(reinit_particles=64),
        scene_points=768, model_points=256, render_size=60, depth_min=0.05,
    )


def concave_mug_sequence(B):
    mesh = B.meshio.make_test_object("mug")
    return B.generate_sequence(mesh, B.hand(points_per_link=128),
                               B.datasets.SyntheticSequenceConfig(
        n_frames=3, camera=B.config.CameraIntrinsics(**CAM_SMALL), noise_sigma=0.0008,
        dropout=0.01, seed=3, step_rot_deg=2.0, step_trans=0.003))


def concave_mug(seed: int = 0, device="cuda", *, backend=None, draws=None) -> Result:
    """test_score_concave.py::test_tracking_concave_mug: a cold start (frame
    0 is an init) on the mug, the last frame < 10 mm."""
    B = backend or PortBackend(device)
    t0 = time.perf_counter()
    mesh = B.meshio.make_test_object("mug")
    obj = B.object(mesh, "mug", model_points=256, render_points=512)
    est = B.estimator(obj, B.hand(points_per_link=128), concave_mug_cfg(B.config))
    tracker = B.tracker(est, seed)
    dense, _ = mesh.sample_surface(4096, seed=123)
    errs = [B.evaluation.add_s_error(B.step(tracker, f.depth, f.hand_base, f.hand_q)[0],
                                     f.pose_gt, dense)
            for f in concave_mug_sequence(B)]
    stats = {"final_adds_mm": _mm(errs)[-1], "adds_mm": _mm(errs)}
    return _result("test_score_concave.py::test_tracking_concave_mug", seed, stats,
                   [Check("final_adds_mm", "<", 10.0)], t0)


# ---------------------------------------------------------------------------
# The table of cases
# ---------------------------------------------------------------------------

class Case(NamedTuple):
    fn: Callable
    args: tuple
    slow: bool          # init-heavy: `slow` on the CPU, on the card every run


def _cases() -> dict:
    out = {}
    for level, _, realistic, _ in LEVELS:
        out[f"test_occlusion_gate.py::test_tracking_under_occlusion[{level}]"] = Case(
            occlusion, (level,), realistic)
    for shape, noise in ACCURACY_THRESHOLDS:
        out[f"test_accuracy_regression.py::test_tracked_adds_pinned[{shape}-{noise}]"] = \
            Case(accuracy, (shape, noise), False)
    for shape, final in REALISTIC_FINAL_MM.items():
        out[f"test_realistic_regression.py::test_realistic_tracking[{shape}-{final}]"] = \
            Case(realistic_tracking, (shape,), False)
    for shape in ("ellipsoid", "asym"):
        out[f"test_realistic_regression.py::test_realistic_init[{shape}]"] = Case(
            realistic_init, (shape,), True)
    out["test_realistic_regression.py::"
        "test_realistic_tracking_base_refine_removes_excursion"] = Case(
            base_refine_excursion, (), False)
    out["test_realistic_regression.py::test_sensor_model_properties"] = Case(
        sensor_model_properties, (), False)
    for realistic, name in ((False, "calibrated"), (True, "miscalibrated")):
        out[f"test_base_refine_auto.py::test_default_config_{name}_regime"] = Case(
            base_refine_auto, (realistic,), True)
    for shape, min_ok in INIT_MIN_OK.items():
        out[f"test_init_success.py::test_global_init_success[{shape}-{min_ok}]"] = Case(
            init_success, (shape,), True)
    for shape in ("box", "cylinder"):
        out[f"test_init_success.py::test_grasp_occluded_slide_case[{shape}-{SLIDE_TRIAL}]"] = \
            Case(slide_case, (shape,), True)
    out["test_score_concave.py::test_tracking_concave_mug"] = Case(concave_mug, (), False)
    return out


CASES = _cases()


def scenario(case: str, seed: int = 0, device="cuda", *, backend=None,
             draws=None) -> list[tuple[Frame, tuple | None]]:
    """Every frame case `case` hands the estimator, in order, when every
    init misses (so each recovery view is rendered), each with the key
    (base, split count, trial, fold_in tag or None) its estimate call takes;
    None for a Tracker step."""
    B, draws = backend or PortBackend(device), draws or PortDraws()
    fn, args = CASES[case].fn, CASES[case].args
    if fn is occlusion:
        return [(f, None) for f in occlusion_scenario(B, draws, *args, seed)]
    seqs = {accuracy: lambda: accuracy_sequence(B, *args),
            realistic_tracking: lambda: realistic_sequence(B, *args),
            base_refine_excursion: lambda: realistic_sequence(B, "asym"),
            concave_mug: lambda: concave_mug_sequence(B)}
    if fn in seqs:
        return [(Frame(f.depth, f.hand_base, f.hand_q, f.pose_gt), None) for f in seqs[fn]()]
    trials = {realistic_init: lambda: realistic_init_trials(B, draws, *args, seed),
              base_refine_auto: lambda: base_refine_trials(B, draws, *args, seed),
              init_success: lambda: init_success_trials(B, draws, *args, seed),
              slide_case: lambda: [slide_trial(B, draws, *args, seed)]}.get(fn)
    out = []
    for tr in (trials() if trials else []):
        out.append((tr.frame, tr.key + (None,)))
        if tr.recovery is not None:
            out.append((tr.recovery(), tr.key + (3,)))
    return out


def run(case: str, seed: int = 0, device="cuda", *, backend=None, draws=None) -> Result:
    """Case `case` (a reference pytest id) at `seed`."""
    c = CASES[case]
    return c.fn(*c.args, seed=seed, device=device, backend=backend, draws=draws)


def configuration(case: str) -> dict:
    """What a case builds, as plain data: the function and its arguments,
    and the estimator configuration of its file (the reference table
    `torch_gate_reference.json` records it, and a tier-1 test holds the
    two together)."""
    from icra20_hand_object_pose_tpu_torch.utils import config

    c = CASES[case]
    if c.fn is concave_mug:
        cfg = concave_mug_cfg(config)
    elif c.fn is accuracy:
        cfg = _cfg(config)
    elif c.fn is base_refine_excursion:
        cfg = _gate_cfg(config, hand=config.HandConfig(base_refine_iters=3))
    else:
        cfg = _gate_cfg(config)
    return {"function": c.fn.__name__, "args": list(c.args), "slow": c.slow,
            "config": _plain(dc.asdict(cfg))}


def _plain(x):
    """JSON's view of a value (tuples become lists)."""
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x
