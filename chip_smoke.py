"""GPU smoke check of the PyTorch/CUDA port (icra20_hand_object_pose_tpu_torch).

    python3 chip_smoke.py                  # one CUDA device, from the repo root
    python3 chip_smoke.py --kernels-only   # build + kernel phases, then stop

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA device is required (no CPU fallback); prints the card's
     name and power limit as nvidia-smi reports them;
  2. build:  compiles every kernel source (csrc/*.cu: K1 and K2 in
     nn_gather.cu, K3 in nn_gn.cu), one nvcc per source started together,
     into one library; prints ptxas' register and spill report;
  3. kernels, each against its plain PyTorch version on the card, timed:
     - K1 at the tracked frame's shapes (in-scan, explorer, polish/support),
       shared and per-particle queries, plus a ragged case: d2 within rtol
       1e-5 / atol 1e-8, >= 99.9% equal indices, bitwise-equal matched
       points and normals where the index agrees;
     - K2 at the same shapes: >= 99.9% equal indices, d2 bitwise equal
       where the index agrees;
     - K3 at the tracked scan (512 x 512 x 256), the explorer pulls (32 x
       512 x 256), the init scan (1024 x 512 x 512) and a ragged case: H,
       g and wrr within rtol 1e-4 plus an atol of 1e-5 x the largest |H|
       entry of that particle (the two sum in other orders), wsum and hits
       within 1e-5 relative;
  4. main path, track (the repo's benchmark configuration: VGA at
     fx=fy=570, box object, T42 hand, 2048 scene / 1024 model / 2048 render
     points, 512 particles x 10 iterations), a splat-rendered frame with
     1 mm noise, a Tracker seeded at the ground truth, 5 calls of
     Tracker.step: no re-init, finite poses, ADD-S < 5 mm, K1 launched;
     then one more frame under torch.profiler (device busy vs idle share,
     and the operators that take the most device time);
  5. cold start: an unseeded Tracker under IcpConfig(fused_gn=True) on the
     same frame: frame 0 re-initialises (TrackerConfig's init program:
     1024 particles x 20 iterations, 4096-orientation prescreen, hand-base
     auto-arm), frames 1-4 track; K3 launched in frame 0 and in the tracked
     frames; frame 0 (or, as recovery credit, frame 1) within ADD-S 10% of
     the diameter, frames 2-4 under 5 mm; then a forced watchdog (fitness
     0) re-initialises, under torch.profiler;
  6. nn_fn: 3 tracked frames with Estimator(nn_fn=make_nn_fn()) seeded at
     the ground truth: K2 launched, K1 not, ADD-S < 5 mm;
  7. prints the kernels' JSON line, then {"ok": true, "device": ...} last.

Each path phase sets every launch count to 0 just before it and reads the
counts just after; the JSON line's `launches` are those of the path that
carries the kernel (K1: phase 4, K3: phase 5, K2: phase 6).
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

REPLACES = {
    "K1": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:220",
    "K2": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:78",
    "K3": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:412",
}
SOURCE = {
    "K1": "icra20_hand_object_pose_tpu_torch/csrc/nn_gather.cu",
    "K2": "icra20_hand_object_pose_tpu_torch/csrc/nn_gather.cu",
    "K3": "icra20_hand_object_pose_tpu_torch/csrc/nn_gn.cu",
}
# (P, Ns, Nm) that the tracked frame hands K1 (and K2 through nn_fn):
# in-scan ICP and support on the 512 x 256 subsets, the 32 explorer seeds on
# the same subsets, the polish and fine-tier support on the full clouds
# (1 + 8 top + 1 explorer + 8 slides = 18 candidates), and one ragged case
NN_SHAPES = [(512, 512, 256), (32, 512, 256), (18, 2048, 1024), (3, 37, 73)]
# (P, Ns, Nm) of K3: the tracked scan, the explorer pulls, the init scan,
# one ragged case
GN_SHAPES = [(512, 512, 256), (32, 512, 256), (1024, 512, 512), (3, 90, 130)]
# published H100 SXM peaks: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) for `ops` FP32 operations and `nbytes`
    moved once, and which of the two sets it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound(P, Pq, Ns, Nm, gather: bool) -> tuple[float, str]:
    """K1/K2: 9 operations per (query, ref) pair (3 sub, 3 mul, 2 add, 1
    compare); query and ref points (and K1's normals) read once, d2 and idx
    (and K1's matched point and normal) written once."""
    n_in = 3 * Pq * Ns + (6 if gather else 3) * P * Nm
    n_out = (8 if gather else 2) * P * Ns
    return bound(9.0 * P * Ns * Nm, 4.0 * (n_in + n_out))


def gn_bound(P, Ns, Nm) -> tuple[float, str]:
    """K3: the search's 9 operations per pair plus ~105 per (particle,
    scene point) for gates, J, r, the 30 products and their sums; scene
    (7 floats a point) and posed model (6) read once, H, g, wsum, hits, wrr
    (45 floats a particle) written once."""
    ops = 9.0 * P * Ns * Nm + 105.0 * P * Ns
    return bound(ops, 4.0 * (7 * Ns + 6 * P * Nm + 45 * P))


def _cloud(gen, shape, dev, scale=0.3, centre=0.5):
    import torch

    c = torch.tensor([0.0, 0.0, centre], device=dev)
    return (torch.rand(shape, generator=gen, device=dev) - 0.5) * scale + c


def nn_phase(knn_cuda, dev, gather: bool) -> dict:
    """K1 (gather) or K2 against its plain version at every main-path shape,
    shared and per-particle queries; returns the in-scan numbers. Both: >=
    99.9% equal indices. K1: d2 within rtol 1e-5 / atol 1e-8, bitwise-equal
    matched points and normals where the index agrees. K2: d2 bitwise equal
    where the index agrees."""
    import torch

    tag = "K1" if gather else "K2"
    gen = torch.Generator(device=dev).manual_seed(0 if gather else 1)
    max_err, res = 0.0, {}
    for P, Ns, Nm in NN_SHAPES:
        for Pq in (1, P):
            q = _cloud(gen, (Pq, Ns, 3), dev)
            q[:, ::17] = 1e6                      # scene padding rows
            r = _cloud(gen, (P, Nm, 3), dev)
            where = f"P={P} Pq={Pq} Ns={Ns} Nm={Nm}"
            if gather:
                n = torch.nn.functional.normalize(
                    torch.randn((P, Nm, 3), generator=gen, device=dev), dim=-1)
                run = lambda: knn_cuda.nn_gather_batched(q, r, n)
                plain = lambda: knn_cuda.nn_gather_plain(q, r, n)
                m, nm, d2, idx = run()
                mp, nmp, d2p, idxp = plain()
            else:
                run = lambda: knn_cuda.nn_batched(q, r)
                plain = lambda: knn_cuda.nn_plain(q, r)
                idx, d2 = run()
                idxp, d2p = plain()
            torch.cuda.synchronize()
            same = idx == idxp
            agree = same.float().mean().item()
            check(agree >= 0.999, f"{tag} index agreement {agree} at {where}")
            if gather:
                check(bool(torch.allclose(d2, d2p, rtol=1e-5, atol=1e-8)),
                      f"K1 d2 disagrees at {where}")
                check(bool(torch.equal(m[same], mp[same])
                           and torch.equal(nm[same], nmp[same])),
                      f"K1 matched point/normal differ at {where}")
            else:
                check(bool(torch.equal(d2[same], d2p[same])),
                      f"K2 d2 not bitwise equal at {where}")
            err = (d2 - d2p).abs().max().item()
            max_err = max(max_err, err)
            reps = 50 if P * Ns * Nm < 1e8 else 20
            k_ms = time_ms(run, reps)
            p_ms = time_ms(plain, max(3, reps // 5))
            b_ms, b_by = nn_bound(P, Pq, Ns, Nm, gather)
            res[(P, Pq, Ns, Nm)] = (k_ms, p_ms, b_ms, b_by)
            print(f"{tag} {where}: idx agree {agree:.6f}, max|d2 err| {err:.3e}, "
                  f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
                  f"({b_by})", flush=True)
    k_ms, p_ms, b_ms, b_by = res[(512, 1, 512, 256)]
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


def k3_phase(knn_cuda, dev) -> dict:
    """K3 vs plain at the tracked scan, explorer, init scan and a ragged
    shape; returns the tracked-scan numbers."""
    import math

    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    gates = dict(maxd2=0.02 ** 2, min_cos=math.cos(math.radians(60.0)),
                 tau2=0.01 ** 2)
    max_err, res = 0.0, {}
    for P, Ns, Nm in GN_SHAPES:
        # anchored clouds of object size; scene padding rows far out, weight 0
        scene = _cloud(gen, (Ns, 3), dev, scale=0.1, centre=0.0)
        snrm = torch.nn.functional.normalize(
            torch.randn((Ns, 3), generator=gen, device=dev), dim=-1)
        snrm[::11] = 0.0                                   # missing normals
        sw = (torch.rand((Ns,), generator=gen, device=dev) > 0.1).float()
        scene[::13] = 1e6
        sw[::13] = 0.0
        ref = _cloud(gen, (P, Nm, 3), dev, scale=0.1, centre=0.0)
        rnrm = torch.nn.functional.normalize(
            torch.randn((P, Nm, 3), generator=gen, device=dev), dim=-1)
        out = knn_cuda.nn_gn_batched(scene, snrm, sw, ref, rnrm, **gates)
        plain = knn_cuda.nn_gn_plain(scene, snrm, sw, ref, rnrm, **gates)
        torch.cuda.synchronize()
        H, g, wsum, hits, wrr = out
        Hp, gp, wsump, hitsp, wrrp = plain
        check(all(bool(torch.isfinite(t).all()) for t in out),
              f"K3 non-finite output at {P, Ns, Nm}")
        scale = Hp.abs().amax(dim=(1, 2))                  # [P]
        errs = []
        for name, a, b in (("H", H, Hp), ("g", g, gp), ("wrr", wrr, wrrp)):
            sc = scale.reshape((P,) + (1,) * (a.dim() - 1))
            ok = (a - b).abs() <= 1e-4 * b.abs() + 1e-5 * sc
            check(bool(ok.all()), f"K3 {name} disagrees at {P, Ns, Nm}: "
                  f"max err {(a - b).abs().max().item():.3e}")
            errs.append((a - b).abs().max().item())
        for name, a, b in (("wsum", wsum, wsump), ("hits", hits, hitsp)):
            check(bool(((a - b).abs() <= 1e-5 * b.abs()).all()),
                  f"K3 {name} disagrees at {P, Ns, Nm}")
        max_err = max(max_err, *errs)
        reps = 50 if P * Ns * Nm < 1e8 else 20
        k_ms = time_ms(lambda: knn_cuda.nn_gn_batched(scene, snrm, sw, ref, rnrm,
                                                      **gates), reps)
        p_ms = time_ms(lambda: knn_cuda.nn_gn_plain(scene, snrm, sw, ref, rnrm,
                                                    **gates), max(3, reps // 5))
        b_ms, b_by = gn_bound(P, Ns, Nm)
        res[(P, Ns, Nm)] = (k_ms, p_ms, b_ms, b_by)
        print(f"K3 P={P} Ns={Ns} Nm={Nm}: max|err| H {errs[0]:.3e} g {errs[1]:.3e} "
              f"wrr {errs[2]:.3e}, mean inlier mass {wsum.mean().item():.2f}, "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.5f} ms "
              f"({b_by})", flush=True)
    k_ms, p_ms, b_ms, b_by = res[(512, 512, 256)]
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by=b_by)


class Scene:
    """BASELINE config 3's frame and models on the card."""

    def __init__(self, dev):
        import numpy as np

        from icra20_hand_object_pose_tpu_torch.datasets import (
            default_object_pose, hand_base_for_grasp, render_frame_fast,
        )
        from icra20_hand_object_pose_tpu_torch.models import (
            ObjectModel, make_t42_hand,
        )
        from icra20_hand_object_pose_tpu_torch.utils import meshio
        from icra20_hand_object_pose_tpu_torch.utils.config import (
            CameraIntrinsics, EstimatorConfig, PsoConfig,
        )

        self.cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                                    cx=320.0, cy=240.0)
        self.cfg = EstimatorConfig(camera=self.cam, scene_points=2048,
                                   pso=PsoConfig(particles=512, iters=10))
        self.mesh = meshio.make_test_object("box")
        self.hand = make_t42_hand(device=dev)
        self.obj = ObjectModel(self.mesh, model_points=1024, render_points=2048,
                               device=dev)
        self.pose_gt = default_object_pose()
        self.hand_base = hand_base_for_grasp(self.pose_gt)
        self.hand_q = np.asarray([0.45, 0.45], np.float32)
        self.depth = render_frame_fast(
            self.mesh, self.pose_gt, self.hand, self.hand_base, self.hand_q,
            self.cam, noise_sigma=0.001, rng=np.random.default_rng(0))
        self.dense, _ = self.mesh.sample_surface(8192, seed=123)

    def step(self, tracker, label: str, profiled: bool = False):
        """One Tracker.step, timed to the pose on the host (under
        torch.profiler when `profiled`); returns (result, ms, ADD-S mm)."""
        import contextlib

        import numpy as np
        import torch
        from torch.profiler import ProfilerActivity, profile

        from icra20_hand_object_pose_tpu_torch import evaluation

        torch.cuda.synchronize()
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            res = tracker.step(self.depth, self.hand_base, self.hand_q)
            pose = res.pose.cpu().numpy()
            ms = 1000.0 * (time.perf_counter() - t0)
        if profiled:
            report_profile(prof, ms)
        check(pose.shape == (4, 4) and bool(np.isfinite(pose).all()),
              f"{label}: pose not finite")
        adds = 1000.0 * evaluation.add_s_error(pose, self.pose_gt, self.dense)
        print(f"{label}: {ms:.2f} ms, ADD-S {adds:.3f} mm, reinitialized "
              f"{res.reinitialized}, fitness {float(res.fitness):.4f}, "
              f"coverage {float(res.coverage):.4f}", flush=True)
        return res, ms, adds


def reset_counts(knn_cuda) -> None:
    for fn in (knn_cuda.nn_gather_batched, knn_cuda.nn_batched,
               knn_cuda.nn_gn_batched):
        fn.launches = 0


def counts(knn_cuda) -> dict:
    return {"K1": knn_cuda.nn_gather_batched.launches,
            "K2": knn_cuda.nn_batched.launches,
            "K3": knn_cuda.nn_gn_batched.launches}


def track_phase(sc: Scene, knn_cuda) -> int:
    """Five tracked frames of the benchmark configuration from the ground
    truth, then one profiled frame; returns the K1 launches of the five."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    tracker = Tracker(Estimator(sc.obj, sc.hand, sc.cfg), seed=0)
    tracker.state = tracker.state._replace(pose=sc.pose_gt, initialized=True,
                                           fitness=1.0)
    reset_counts(knn_cuda)
    frame_ms = []
    for i in range(5):
        res, ms, adds = sc.step(tracker, f"track frame {i}")
        frame_ms.append(ms)
        check(not res.reinitialized, f"frame {i} re-initialized")
        check(adds < 5.0, f"frame {i}: ADD-S {adds:.3f} mm >= 5 mm")
    n = counts(knn_cuda)
    check(n["K1"] > 0, "the tracked frames never launched K1")
    steady = sum(frame_ms[1:]) / len(frame_ms[1:])
    print(f"Tracker.step: {steady:.2f} ms/frame (frames 1-4; frame 0 "
          f"{frame_ms[0]:.2f} ms), launches in 5 frames {n}", flush=True)
    sc.step(tracker, "profiled track frame", profiled=True)
    return n["K1"]


def report_profile(prof, wall_ms: float) -> None:
    """Device kernel time against the frame's wall time gives the card's
    idle share; then the operators that take the most device time."""
    from torch.autograd import DeviceType

    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False)) / 1000.0
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    print(f"profiled frame: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms device "
          f"kernels ({100.0 * (1.0 - busy_ms / wall_ms):.1f}% idle), "
          f"{n_ops} aten operator calls", flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=15),
          flush=True)


def cold_start_phase(sc: Scene, knn_cuda) -> int:
    """An unseeded Tracker under IcpConfig(fused_gn=True): init on frame 0,
    tracking on frames 1-4, then a forced re-init; returns K3's launches."""
    import dataclasses

    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    cfg = dataclasses.replace(sc.cfg, icp=dataclasses.replace(sc.cfg.icp,
                                                               fused_gn=True))
    tracker = Tracker(Estimator(sc.obj, sc.hand, cfg), seed=0)
    limit = 0.1 * 1000.0 * sc.obj.diameter
    reset_counts(knn_cuda)
    adds, ms, per_frame = [], [], []
    for i in range(5):
        before = counts(knn_cuda)
        res, t, a = sc.step(tracker, f"cold-start frame {i}")
        after = counts(knn_cuda)
        per_frame.append({k: after[k] - before[k] for k in after})
        adds.append(a)
        ms.append(t)
        check(res.reinitialized == (i == 0),
              f"cold-start frame {i}: reinitialized={res.reinitialized}")
        check(per_frame[-1]["K3"] > 0, f"cold-start frame {i} never launched K3")
    check(adds[0] < limit or adds[1] < limit,
          f"init missed: ADD-S {adds[0]:.3f} / {adds[1]:.3f} mm, limit {limit:.3f} mm")
    check(max(adds[2:]) < 5.0, f"tracked frames 2-4 ADD-S {adds[2:]} >= 5 mm")
    print(f"cold start: init frame {ms[0]:.2f} ms, tracked frames 1-4 "
          f"{sum(ms[1:]) / 4:.2f} ms/frame; launches, init frame "
          f"{per_frame[0]}, each tracked frame {per_frame[1:]}", flush=True)
    tracker.state = tracker.state._replace(fitness=0.0)
    res, t, a = sc.step(tracker, "profiled forced re-init", profiled=True)
    check(res.reinitialized, "the forced watchdog did not re-initialise")
    n = counts(knn_cuda)
    print(f"cold-start path launches (5 frames + forced re-init): {n}", flush=True)
    return n["K3"]


def nn_fn_phase(sc: Scene, knn_cuda) -> int:
    """Three tracked frames through Estimator(nn_fn=K2) from the ground
    truth; returns K2's launches."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    tracker = Tracker(Estimator(sc.obj, sc.hand, sc.cfg,
                                nn_fn=knn_cuda.make_nn_fn()), seed=0)
    tracker.state = tracker.state._replace(pose=sc.pose_gt, initialized=True,
                                           fitness=1.0)
    reset_counts(knn_cuda)
    ms = []
    for i in range(3):
        res, t, a = sc.step(tracker, f"nn_fn frame {i}")
        ms.append(t)
        check(not res.reinitialized, f"nn_fn frame {i} re-initialized")
        check(a < 5.0, f"nn_fn frame {i}: ADD-S {a:.3f} mm >= 5 mm")
    n = counts(knn_cuda)
    check(n["K2"] > 0 and n["K1"] == 0, f"nn_fn path launches {n}")
    print(f"nn_fn path: {sum(ms[1:]) / 2:.2f} ms/frame (frames 1-2), "
          f"launches in 3 frames {n}", flush=True)
    return n["K2"]


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _, log = knn_cuda.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if line.startswith("==") or any(k in line for k in (
                "Compiling entry", "registers", "spill")):
            print("  ptxas:", line.strip(), flush=True)

    stats = {"K1": nn_phase(knn_cuda, dev, gather=True),
             "K2": nn_phase(knn_cuda, dev, gather=False),
             "K3": k3_phase(knn_cuda, dev)}
    if "--kernels-only" in argv:
        print(smi, flush=True)
        return 0
    sc = Scene(dev)
    launches = {"K1": track_phase(sc, knn_cuda),
                "K3": cold_start_phase(sc, knn_cuda),
                "K2": nn_fn_phase(sc, knn_cuda)}

    names = {"K1": "nn_gather_batched", "K2": "nn_batched", "K3": "nn_gn_batched"}
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": names[k], "route": "cuda", "source": SOURCE[k],
        "replaces": REPLACES[k], "launches": launches[k],
        **stats[k], "library_ms": None,
    } for k in ("K1", "K2", "K3")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
