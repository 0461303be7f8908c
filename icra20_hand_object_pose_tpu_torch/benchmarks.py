"""Benchmarks of the port (counterpart of benchmarks.py; the repo-root
`bench_torch.py` shim and `cli bench` are the entry points).

Headline: ICP-refined pose hypotheses/s on one card at 512 particles. Every
PSO iteration renders, scores and ICP-refines the whole 512-particle swarm,
so one frame performs particles x pso_iters ICP-refined hypothesis
evaluations (BASELINE.json: >= 1000/s).

Each function prints ONE JSON line with the reference's keys, and returns
it as a dict. Every function takes `device="cuda"` (no CPU fallback: pass
"cpu" for a machine without a card) and keyword sizes whose defaults are the
reference's, so a call with no arguments runs exactly its configuration; the
CPU tests run them small.

Random draws. The reference draws trial orientations and recovery
perturbations from `jax.random` keys (`split(key(seed), n_trials)`, then
`fold_in(keys[t], k)`). The port cannot reproduce threefry, so it draws
them on the host from a `torch.Generator` seeded with `_fold(seed, t, k)`,
the same (seed, trial, tag) arithmetic: the same trials on every device,
not the reference's. The `render_frame` noise keeps the reference's numpy
seeds.

Times are host clocks around work that ends in the result copied to the
host. `device_ms_per_frame` comes from one frame under torch.profiler after
the timed loop; the profiler loses events of few-microsecond kernels, so it
is a lower bound of the card's busy time and `idle_share` an upper bound.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

# BASELINE.json: >= 1000 ICP-refined hypotheses/s on one chip
BASELINE_TARGET = 1000.0
SHAPES = ("box", "cylinder", "ellipsoid", "asym", "tee", "mug")


def _emit(rec: dict) -> dict:
    print(json.dumps(rec), flush=True)
    return rec


def _fold(seed: int, trial: int, tag: int) -> int:
    """An integer seed for draw `tag` of trial `trial` (the reference's
    fold_in(split(key(seed))[trial], tag))."""
    return int(np.random.SeedSequence([seed, trial, tag]).generate_state(1)[0])


def _host_gen(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


def _random_rotation(seed: int) -> np.ndarray:
    from .utils import se3

    return se3.random_rotation(_host_gen(seed)).numpy()


def _perturb(seed: int, pose: np.ndarray, rot_sigma: float,
             trans_sigma: float) -> np.ndarray:
    from .utils import se3

    return se3.perturb_pose(
        _host_gen(seed), torch.as_tensor(np.asarray(pose, np.float32)),
        rot_sigma, trans_sigma).numpy().astype(np.float32)


def _camera(width: int, height: int, fov_f: float):
    from .utils.config import CameraIntrinsics

    return CameraIntrinsics(width=width, height=height, fx=fov_f, fy=fov_f,
                            cx=width / 2, cy=height / 2)


def _config(cam, *, particles, iters, scene_points, reinit_particles=None,
            prescreen=None):
    """EstimatorConfig on `cam`; reinit_particles / prescreen None keep
    TrackerConfig's defaults."""
    from .utils.config import EstimatorConfig, PsoConfig, TrackerConfig

    tr = {}
    if reinit_particles is not None:
        tr["reinit_particles"] = reinit_particles
    if prescreen is not None:
        tr["reinit_prescreen"] = prescreen
    return EstimatorConfig(camera=cam, scene_points=scene_points,
                           pso=PsoConfig(particles=particles, iters=iters),
                           tracker=TrackerConfig(**tr))


def _device_fields(device) -> dict:
    """`device` (the card's name, or "cpu") and `power_limit_w` (the card's
    power limit as nvidia-smi reports it; None on the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": float(out.strip().splitlines()[0])}


def bench_sweep(n_objects: int = 8, particles: int = 128, shared: bool = False,
                device="cuda", *, width: int = 640, height: int = 480,
                fov_f: float = 570.0, iters: int = 10, scene_points: int = 2048,
                model_points: int = 1024, render_points: int = 2048,
                reinit_particles: int | None = None,
                prescreen: int | None = None, reps: int = 5) -> dict:
    """BASELINE config 5: a model library tracked as one batched program
    (parallel.LibrarySweep). One JSON line with hypotheses/s so that the
    per-card rate compares with the single-object headline at matched
    particle counts (`--sweep-scale` runs 8 x 512 and 16 x 128).

    `shared=True` benches the shared-scene mode (one observed frame, O
    candidate models; `_scene_prep` runs once per step instead of O times)
    on O copies of the true model, so every candidate locks and the steady
    state is pure tracking in both modes: O different models on one scene
    is the library-identification workload, where the mis-fitting
    candidates re-run the init program every frame."""
    from .datasets import default_object_pose, hand_base_for_grasp, render_frame_fast
    from .models import ObjectModel, make_t42_hand
    from .parallel import LibrarySweep
    from .utils import meshio

    cam = _camera(width, height, fov_f)
    cfg = _config(cam, particles=particles, iters=iters, scene_points=scene_points,
                  reinit_particles=reinit_particles, prescreen=prescreen)
    if shared:
        meshes = [meshio.make_test_object("box") for _ in range(n_objects)]
    else:
        shapes = ["box", "cylinder", "sphere", "ellipsoid"]
        meshes = [meshio.make_test_object(shapes[i % 4]) for i in range(n_objects)]
    hand = make_t42_hand(device=device)
    objs = [ObjectModel(m, model_points=model_points, render_points=render_points,
                        seed=i, device=device) for i, m in enumerate(meshes)]
    sweep = LibrarySweep(objs, hand, cfg, shared_scene=shared)
    pose_gt = default_object_pose()
    hb = hand_base_for_grasp(pose_gt)
    hq = np.asarray([0.45, 0.45], np.float32)
    if shared:
        depths = render_frame_fast(meshes[0], pose_gt, hand, hb, hq, cam,
                                   noise_sigma=0.001, device=device)
        hbs, hqs = hb, hq
    else:
        depths = np.stack([render_frame_fast(m, pose_gt, hand, hb, hq, cam,
                                             noise_sigma=0.001, device=device)
                           for m in meshes])
        hbs = np.stack([hb] * n_objects)
        hqs = np.stack([hq] * n_objects)
    # on the device once, as the frames of a live loop arrive
    depths, hbs, hqs = (torch.as_tensor(np.asarray(a, np.float32), device=sweep.device)
                        for a in (depths, hbs, hqs))

    st = sweep.init_state()
    # warm-up: step 0 runs the init program on the fresh state (and builds
    # the kernels at first use), step 1 the track program
    for _ in range(2):
        st, res = sweep.step(st, depths, hbs, hqs)
        res.poses.cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        st, res = sweep.step(st, depths, hbs, hqs)
    res.poses.cpu()
    dt = (time.perf_counter() - t0) / reps
    value = n_objects / dt
    return _emit({
        "metric": (f"library_sweep_objects_tracked_per_sec_{n_objects}obj"
                   f"_{particles}p" + ("_shared_scene" if shared else "")),
        "value": round(value, 2),
        "unit": "object-frames/sec/chip",
        "vs_baseline": round(value * particles * iters / BASELINE_TARGET, 3),
        "hyp_per_sec_chip": round(n_objects * particles * iters / dt, 1),
        "ms_per_object_frame": round(dt / n_objects * 1000.0, 2),
        **_device_fields(device),
    })


def _calibration(realistic: bool, hb, hq, cal_rng):
    """(reported hand base, true joint q, calibration error) of one trial;
    reported = err @ true base (the camera-extrinsic convention of
    datasets.generate_sequence)."""
    from .utils import se3

    if not realistic:
        return hb, hq, np.eye(4, dtype=np.float32)
    w = cal_rng.normal(size=3)
    w = w / np.linalg.norm(w) * np.radians(3.0)
    v = cal_rng.normal(size=3)
    v = v / np.linalg.norm(v) * 5e-3
    err = se3.se3_exp(torch.as_tensor(np.concatenate([w, v]), dtype=torch.float32)
                      ).numpy().astype(np.float32)
    q_true = hq + cal_rng.choice([-0.15, 0.15])
    return (err @ hb).astype(np.float32), q_true.astype(np.float32), err


def bench_init(n_trials: int = 30, seed: int = 0, device="cuda", *,
               width: int = 640, height: int = 480, fov_f: float = 570.0,
               particles: int = 512, scene_points: int = 2048,
               model_points: int = 1024, render_points: int = 2048,
               prescreen: int | None = None,
               shapes: tuple = SHAPES, realistic: bool = False) -> dict:
    """Global-registration success over the shape library.

    Per shape: n_trials random-orientation grasp frames (exact raster, 1 mm
    noise), recovery from no prior (mode="init") with TrackerConfig's init
    program at 2x the tracking swarm. success_frame0: dense ADD-S < 10% of
    the diameter on the init frame; a frame-0 failure gets ONE tracked frame
    on a slightly moved second view (the hand moves with the object) and
    counts as recovered if that frame succeeds. success = (frame-0 successes
    + one-frame recoveries) / n_trials. `realistic=True` adds the full
    sensor model and a hand calibration error (base 5 mm / 3 degrees off,
    joints 0.15 rad off the true closure); the default configuration runs in
    both regimes (the hand-base refine auto-arms in the init program)."""
    from .datasets import SensorModel, hand_base_for_grasp, render_frame
    from .evaluation import add_s_error
    from .models import Estimator, ObjectModel, make_t42_hand
    from .utils import meshio

    cam = _camera(width, height, fov_f)
    cfg = _config(cam, particles=particles, iters=10, scene_points=scene_points,
                  reinit_particles=2 * particles, prescreen=prescreen)
    sensor = SensorModel() if realistic else None
    hand = make_t42_hand(device=device)
    hq = np.asarray([0.45, 0.45], np.float32)
    eye = np.eye(4, dtype=np.float32)

    per_shape = {}
    worst = 1.0
    for shape in shapes:
        mesh = meshio.make_test_object(shape)
        obj = ObjectModel(mesh, model_points=model_points,
                          render_points=render_points, device=device)
        est = Estimator(obj, hand, cfg)
        dense, _ = mesh.sample_surface(8192, seed=123)
        rng = np.random.default_rng(seed)
        n_f0, n_rec = 0, 0
        errs_ok = []
        t0 = time.perf_counter()
        for t in range(n_trials):
            pose_gt = np.eye(4, dtype=np.float32)
            pose_gt[:3, :3] = _random_rotation(_fold(seed, t, 1))
            pose_gt[:3, 3] = [rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                              rng.uniform(0.40, 0.65)]
            hb = hand_base_for_grasp(pose_gt)
            hb_rep, q_true, cal_err = _calibration(
                realistic, hb, hq, np.random.default_rng(seed * 7000 + t))
            depth = render_frame(mesh, pose_gt, hand, hb, q_true, cam,
                                 noise_sigma=0.001,
                                 rng=np.random.default_rng(seed * 1000 + t),
                                 sensor=sensor, device=device)
            out = est.estimate(depth, eye, hb_rep, hq, key=_fold(seed, t, 0),
                               mode="init")
            e = add_s_error(out.pose.cpu().numpy(), pose_gt, dense)
            if e < 0.1 * obj.diameter:
                n_f0 += 1
                errs_ok.append(e)
                continue
            # one tracked frame on a slightly moved view: the hand moves
            # with the grasped object, the reported base keeps the
            # calibration error left-multiplied
            pose1 = _perturb(_fold(seed, t, 2), pose_gt, 0.035, 0.002)
            hb1 = (pose1 @ np.linalg.inv(pose_gt) @ hb).astype(np.float32)
            depth1 = render_frame(mesh, pose1, hand, hb1, q_true, cam,
                                  noise_sigma=0.001,
                                  rng=np.random.default_rng(seed * 1000 + t + 500_000),
                                  sensor=sensor, device=device)
            out1 = est.estimate(depth1, out.pose, (cal_err @ hb1).astype(np.float32),
                                hq, key=_fold(seed, t, 3), mode="track")
            e1 = add_s_error(out1.pose.cpu().numpy(), pose1, dense)
            if e1 < 0.1 * obj.diameter:
                n_rec += 1
                errs_ok.append(e1)
        dt = time.perf_counter() - t0
        rate = (n_f0 + n_rec) / n_trials
        worst = min(worst, rate)
        per_shape[shape] = {
            "success": round(rate, 3),
            "success_frame0": round(n_f0 / n_trials, 3),
            "recovered_frame1": n_rec,
            "adds_mm_median_success": (
                round(float(np.median(errs_ok)) * 1000, 2) if errs_ok else None),
            "s_per_trial": round(dt / n_trials, 2),
        }
    return _emit({
        "metric": (f"global_init_success_per_shape_{n_trials}trials_vga"
                   + ("_realistic" if realistic else "")),
        "value": round(worst, 3),           # the headline is the worst shape
        "unit": "fraction",
        "vs_baseline": round(worst / 0.9, 3),   # target >= 90% per shape
        "per_shape": per_shape,
        **_device_fields(device),
    })


def bench_sweep_init(n_trials: int = 12, seed: int = 0, device="cuda", *,
                     width: int = 640, height: int = 480, fov_f: float = 570.0,
                     particles: int = 512, scene_points: int = 2048,
                     model_points: int = 1024, render_points: int = 2048,
                     prescreen: int | None = None,
                     shapes: tuple = SHAPES) -> dict:
    """Global-registration success in sweep mode: per trial every shape gets
    a random-orientation grasp frame and ONE sweep step from a fresh state
    (all objects init together, through the same init program as a single
    Tracker); a frame-0 failure gets one tracked sweep step on a slightly
    moved view (the recovery credit of `bench_init`)."""
    from .datasets import hand_base_for_grasp, render_frame
    from .evaluation import add_s_error
    from .models import ObjectModel, make_t42_hand
    from .parallel import LibrarySweep
    from .utils import meshio

    cam = _camera(width, height, fov_f)
    cfg = _config(cam, particles=particles, iters=10, scene_points=scene_points,
                  reinit_particles=2 * particles, prescreen=prescreen)
    hand = make_t42_hand(device=device)
    hq = np.asarray([0.45, 0.45], np.float32)
    meshes = [meshio.make_test_object(s) for s in shapes]
    objs = [ObjectModel(m, model_points=model_points, render_points=render_points,
                        device=device) for m in meshes]
    dense = [m.sample_surface(8192, seed=123)[0] for m in meshes]
    sweep = LibrarySweep(objs, hand, cfg)
    n_obj = len(shapes)
    ok_f0 = np.zeros(n_obj, int)
    ok_rec = np.zeros(n_obj, int)
    errs_ok = [[] for _ in range(n_obj)]
    hqs = np.stack([hq] * n_obj)
    rng = np.random.default_rng(seed)
    t_start = time.perf_counter()
    for t in range(n_trials):
        gts, hbs, depths = [], [], []
        for i in range(n_obj):
            gt = np.eye(4, dtype=np.float32)
            gt[:3, :3] = _random_rotation(_fold(seed, t, 10 + i))
            gt[:3, 3] = [rng.uniform(-0.08, 0.08), rng.uniform(-0.06, 0.06),
                         rng.uniform(0.40, 0.65)]
            hb = hand_base_for_grasp(gt)
            depths.append(render_frame(
                meshes[i], gt, hand, hb, hq, cam, noise_sigma=0.001,
                rng=np.random.default_rng(seed * 1000 + t * 10 + i), device=device))
            gts.append(gt)
            hbs.append(hb)
        st = sweep.init_state(seed=seed * 100 + t)
        st, res = sweep.step(st, np.stack(depths), np.stack(hbs), hqs)
        poses = res.poses.cpu().numpy()
        failed = []
        for i in range(n_obj):
            e = add_s_error(poses[i], gts[i], dense[i])
            if e < 0.1 * objs[i].diameter:
                ok_f0[i] += 1
                errs_ok[i].append(e)
            else:
                failed.append(i)
        if failed:
            gts1, hbs1, depths1 = [], [], []
            for i in range(n_obj):
                p1 = _perturb(_fold(seed, t, 100 + i), gts[i], 0.035, 0.002)
                hb1 = (p1 @ np.linalg.inv(gts[i]) @ hbs[i]).astype(np.float32)
                depths1.append(render_frame(
                    meshes[i], p1, hand, hb1, hq, cam, noise_sigma=0.001,
                    rng=np.random.default_rng(seed * 1000 + t * 10 + i + 500_000),
                    device=device))
                gts1.append(p1)
                hbs1.append(hb1)
            st, res1 = sweep.step(st, np.stack(depths1), np.stack(hbs1), hqs)
            poses1 = res1.poses.cpu().numpy()
            for i in failed:
                e1 = add_s_error(poses1[i], gts1[i], dense[i])
                if e1 < 0.1 * objs[i].diameter:
                    ok_rec[i] += 1
                    errs_ok[i].append(e1)
    dt = time.perf_counter() - t_start
    per_shape = {}
    worst = 1.0
    for i, s in enumerate(shapes):
        rate = (ok_f0[i] + ok_rec[i]) / n_trials
        worst = min(worst, rate)
        per_shape[s] = {
            "success": round(rate, 3),
            "success_frame0": round(ok_f0[i] / n_trials, 3),
            "recovered_frame1": int(ok_rec[i]),
            "adds_mm_median_success": (
                round(float(np.median(errs_ok[i])) * 1000, 2) if errs_ok[i] else None),
        }
    return _emit({
        "metric": f"sweep_global_init_success_per_shape_{n_trials}trials_vga",
        "value": round(worst, 3),           # the headline is the worst shape
        "unit": "fraction",
        "vs_baseline": round(worst / 0.9, 3),   # target >= 90% per shape
        "s_per_trial": round(dt / n_trials, 2),
        "per_shape": per_shape,
        **_device_fields(device),
    })


def full_refine_equivalents_per_frame(cfg) -> float:
    """Frame work in units of ONE reference-style full refine.

    The headline counts particles x PSO iterations, where each in-scan
    refinement is icp_iters_inner NN searches x gn_reps GN re-linearizations
    on stochastic subsets, not the reference's full 30-iteration refine on
    the full clouds. This converts: the correspondence-search point pairs
    evaluated per frame (the dominant ICP cost; the GN algebra rides along)
    over the pairs of one full refine (30 iters x scene_points x
    model_points), from the same config the benchmark runs."""
    p, ic, sc = cfg.pso, cfg.icp, cfg.score
    ns, nm = cfg.scene_points, cfg.model_points
    ks, km = min(p.icp_scene_subset, ns), min(p.icp_model_subset, nm)
    pairs = 0.0
    # in-scan stochastic ICP: one refine per icp_every scan iterations, each
    # icp_iters_inner NN searches over [P, ks] x [P, km]
    if p.icp_every > 0:
        n_refines = (p.iters + p.icp_every - 1) // p.icp_every
        pairs += n_refines * p.icp_iters_inner * p.particles * ks * km
    # explorer seeds: 3 refine calls outside the swarm (ops/pso.py)
    n_explore = int(round(p.particles * p.explore_frac))
    if n_explore:
        pairs += 3 * p.icp_iters_inner * n_explore * ks * km
    # fine-tier polish: full-cloud ICP over the candidate set
    n_cand = min(p.polish_top_k, p.particles - 1) + 1 + (1 if n_explore else 0)
    if p.slide_proposals > 1:
        n_cand += 2 * (p.slide_proposals // 2)
    pairs += ic.iters * n_cand * ns * nm
    # explicit full-cloud scene-support search for the raw candidates
    if sc.scene_cov_weight > 0:
        pairs += n_cand * ns * nm
    return pairs / (30.0 * ns * nm)


def main(device="cuda", *, width: int = 640, height: int = 480,
         fov_f: float = 570.0, particles: int = 512, iters: int = 10,
         scene_points: int = 2048, model_points: int = 1024,
         render_points: int = 2048, reps: int = 8,
         tracker_warmup: int = 13) -> dict:
    """BASELINE config 3 (512-particle PSO with render-and-compare and
    finger-occlusion masks on a splat-rendered grasp frame, box, T42 hand).

    `ms_per_frame` times the frame program alone: `Estimator.estimate` on
    the ground-truth prior with a new seed each rep, `reps` reps after one
    warm-up (which builds the kernels at first use and captures the
    program: utils/program.py), the loop ending in the pose copied to the
    host. `eager_ms_per_frame` times the same frames through the traced
    function run eagerly (`Estimator._frame_step`), in the same run.
    `e2e_tracker_ms_per_frame` times `Tracker.step`
    (the number a control loop sees) on a state seeded at the ground truth:
    `tracker_warmup` steps, then 2 x reps timed. Then one frame under
    torch.profiler: `device_ms_per_frame` (a lower bound, see the module
    notes), `idle_share` = 1 - device / wall ms of that frame, and
    `aten_calls_per_frame` (on the card, the host's operators outside the
    replayed graph: a replay issues none of the frame's own); null on the
    CPU, which has no device time."""
    from .datasets import default_object_pose, hand_base_for_grasp, render_frame_fast
    from .models import Estimator, ObjectModel, Tracker, make_t42_hand
    from .utils import meshio
    from .utils.profiling import profile_counts

    cam = _camera(width, height, fov_f)
    cfg = _config(cam, particles=particles, iters=iters, scene_points=scene_points)
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(device=device)
    obj = ObjectModel(mesh, model_points=model_points, render_points=render_points,
                      device=device)
    pose_gt = default_object_pose()
    hb = hand_base_for_grasp(pose_gt)
    hq = np.asarray([0.45, 0.45], np.float32)
    est = Estimator(obj, hand, cfg)
    # on the device once, as the frames of a live loop arrive
    depth, prev, hb, hq = (est._tensor(a) for a in (
        render_frame_fast(mesh, pose_gt, hand, hb, hq, cam, noise_sigma=0.001,
                          device=device), pose_gt, hb, hq))

    def frame(seed: int) -> np.ndarray:
        return est.estimate(depth, prev, hb, hq, key=seed, mode="track"
                            ).pose.cpu().numpy()

    frame(0)                                  # warm-up, kernel build included
    t0 = time.perf_counter()
    for i in range(reps):
        out = est.estimate(depth, prev, hb, hq, key=i + 1, mode="track")
    out.pose.cpu()
    dt = (time.perf_counter() - t0) / reps

    args = [est.frame_args(depth, prev, hb, hq, key=i + 1, mode="track")
            for i in range(reps)]
    t0 = time.perf_counter()
    for dyn, static in args:
        out = est._frame_step(*dyn, **static)
    out.pose.cpu()
    dt_eager = (time.perf_counter() - t0) / reps

    trk = Tracker(est, seed=0)
    trk.state = trk.state._replace(pose=prev, initialized=True, fitness=1.0)
    for _ in range(tracker_warmup):
        trk.step(depth, hb, hq)
    trk.state.pose.cpu()
    t0 = time.perf_counter()
    for _ in range(2 * reps):
        trk.step(depth, hb, hq)
    trk.state.pose.cpu()
    dt_e2e = (time.perf_counter() - t0) / (2 * reps)

    prof = profile_counts(frame, reps + 1, device=device)
    on_card = torch.device(device).type == "cuda"
    value = particles * iters / dt
    return _emit({
        "metric": "icp_refined_pose_hypotheses_per_sec_per_chip_512p",
        "value": round(value, 1),
        "unit": "hypotheses/sec/chip",
        "vs_baseline": round(value / BASELINE_TARGET, 3),
        "ms_per_frame": round(dt * 1000.0, 2),
        "eager_ms_per_frame": round(dt_eager * 1000.0, 2),
        "e2e_tracker_ms_per_frame": round(dt_e2e * 1000.0, 2),
        "full_refine_equiv_per_sec": round(
            full_refine_equivalents_per_frame(cfg) / dt, 1),
        "device_ms_per_frame": round(prof["device_ms"], 3) if on_card else None,
        "idle_share": (round(1.0 - prof["device_ms"] / prof["wall_ms"], 4)
                       if on_card else None),
        "aten_calls_per_frame": prof["aten_calls"],
        **_device_fields(device),
    })


def cli(argv=None) -> None:
    """`python3 bench_torch.py [--sweep | --sweep-scale | --sweep-shared |
    --sweep-init | --init | --init-realistic] [--device cuda]`: with no flag
    the headline (`main`)."""
    import argparse

    ap = argparse.ArgumentParser(prog="bench_torch.py", description=cli.__doc__)
    for flag in ("--sweep", "--sweep-scale", "--sweep-shared", "--sweep-init",
                 "--init", "--init-realistic"):
        ap.add_argument(flag, action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu on a machine "
                         "without a card)")
    a = ap.parse_args(argv)
    dev = a.device
    if a.sweep_scale:
        # matched-scale per-card efficiency: the same hypothesis budget as
        # two library shapes
        bench_sweep(n_objects=8, particles=512, device=dev)
        bench_sweep(n_objects=16, particles=128, device=dev)
    elif a.sweep_init:
        bench_sweep_init(device=dev)
    elif a.sweep_shared:
        # model-library mode beside --sweep: the same library and particles,
        # one shared observed frame instead of one per object
        bench_sweep(shared=True, device=dev)
        bench_sweep(n_objects=8, particles=512, shared=True, device=dev)
    elif a.sweep:
        bench_sweep(device=dev)
    elif a.init_realistic:
        bench_init(realistic=True, device=dev)
    elif a.init:
        bench_init(device=dev)
    else:
        main(device=dev)


if __name__ == "__main__":
    cli()
