"""GPU smoke check of the PyTorch/CUDA port (icra20_hand_object_pose_tpu_torch).

    python3 chip_smoke.py     # one CUDA device, from the repo root

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA device is required (no CPU fallback); prints the card's
     name and power limit as nvidia-smi reports them;
  2. build:  compiles kernel K1 (csrc/nn_gather.cu) from this checkout;
  3. kernel: K1 against its plain PyTorch version on the card at the main
     path's shapes (in-scan, explorer, polish/support), shared and
     per-particle queries, plus a ragged case; d2 within rtol 1e-5 /
     atol 1e-8, >= 99.9% equal indices, bitwise-equal matched points and
     normals where the index agrees; times both;
  4. main path: the repo's benchmark configuration (VGA at fx=fy=570, box
     object, T42 hand, 2048 scene / 1024 model / 2048 render points, 512
     particles x 10 iterations), a splat-rendered frame with 1 mm noise,
     a Tracker seeded at the ground truth, 5 calls of Tracker.step: no
     re-init, finite poses, ADD-S < 5 mm, K1 launched by the frames;
     then one more frame under torch.profiler (device busy vs idle share,
     and the operators that take the most device time);
  5. prints the kernels' JSON line, then {"ok": true, "device": ...} last.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
K1_REPLACES = "icra20_hand_object_pose_tpu/ops/knn_pallas.py:220"
K1_SOURCE = "icra20_hand_object_pose_tpu_torch/csrc/nn_gather.cu"
# (P, Ns, Nm) that the tracked frame hands K1: in-scan ICP and support on
# the 512 x 256 subsets, the 32 explorer seeds on the same subsets, the
# polish and fine-tier support on the full clouds (1 + 8 top + 1 explorer
# + 8 slides = 18 candidates), and one ragged case
K1_SHAPES = [(512, 512, 256), (32, 512, 256), (18, 2048, 1024), (3, 37, 73)]


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


def kernel_phase(knn_cuda, dev) -> tuple[float, float, float]:
    """K1 vs plain at every main-path shape; returns (max |d2 err|, kernel
    ms, plain ms) with the times at the in-scan shape."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(0)
    centre = torch.tensor([0.0, 0.0, 0.5], device=dev)
    max_err, times = 0.0, {}
    for P, Ns, Nm in K1_SHAPES:
        for Pq in (1, P):
            q = (torch.rand((Pq, Ns, 3), generator=gen, device=dev) - 0.5) * 0.3 + centre
            q[:, ::17] = 1e6                      # scene padding rows
            r = (torch.rand((P, Nm, 3), generator=gen, device=dev) - 0.5) * 0.3 + centre
            n = torch.nn.functional.normalize(
                torch.randn((P, Nm, 3), generator=gen, device=dev), dim=-1)
            m, nm, d2, idx = knn_cuda.nn_gather_batched(q, r, n)
            mp, nmp, d2p, idxp = knn_cuda.nn_gather_plain(q, r, n)
            torch.cuda.synchronize()
            check(bool(torch.allclose(d2, d2p, rtol=1e-5, atol=1e-8)),
                  f"K1 d2 disagrees at P={P} Pq={Pq} Ns={Ns} Nm={Nm}")
            same = idx == idxp
            agree = same.float().mean().item()
            check(agree >= 0.999, f"K1 index agreement {agree} at {P, Pq, Ns, Nm}")
            check(bool(torch.equal(m[same], mp[same]) and torch.equal(nm[same], nmp[same])),
                  f"K1 matched point/normal differ at {P, Pq, Ns, Nm}")
            err = (d2 - d2p).abs().max().item()
            max_err = max(max_err, err)
            reps = 50 if P * Ns * Nm < 1e8 else 20
            k_ms = time_ms(lambda: knn_cuda.nn_gather_batched(q, r, n), reps)
            p_ms = time_ms(lambda: knn_cuda.nn_gather_plain(q, r, n), max(3, reps // 5))
            times[(P, Pq, Ns, Nm)] = (k_ms, p_ms)
            print(f"K1 P={P} Pq={Pq} Ns={Ns} Nm={Nm}: idx agree {agree:.6f}, "
                  f"max|d2 err| {err:.3e}, kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms",
                  flush=True)
    k_ms, p_ms = times[(512, 1, 512, 256)]
    return max_err, k_ms, p_ms


def main_path_phase(dev) -> int:
    """Five tracked frames of the benchmark configuration, then one
    profiled frame; returns the K1 launches of the five."""
    import numpy as np
    import torch

    from icra20_hand_object_pose_tpu_torch import evaluation
    from icra20_hand_object_pose_tpu_torch.datasets import (
        default_object_pose, hand_base_for_grasp, render_frame_fast,
    )
    from icra20_hand_object_pose_tpu_torch.models import (
        Estimator, ObjectModel, Tracker, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
    from icra20_hand_object_pose_tpu_torch.utils import meshio
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig,
    )

    cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                           cx=320.0, cy=240.0)
    cfg = EstimatorConfig(camera=cam, scene_points=2048,
                          pso=PsoConfig(particles=512, iters=10))
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(device=dev)
    obj = ObjectModel(mesh, model_points=1024, render_points=2048, device=dev)
    pose_gt = default_object_pose()
    hand_base = hand_base_for_grasp(pose_gt)
    hand_q = np.asarray([0.45, 0.45], np.float32)
    depth = render_frame_fast(mesh, pose_gt, hand, hand_base, hand_q, cam,
                              noise_sigma=0.001, rng=np.random.default_rng(0))
    dense, _ = mesh.sample_surface(8192, seed=123)

    tracker = Tracker(Estimator(obj, hand, cfg), seed=0)
    tracker.state = tracker.state._replace(pose=pose_gt, initialized=True,
                                           fitness=1.0)
    knn_cuda.nn_gather_batched.launches = 0
    frame_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tracker.step(depth, hand_base, hand_q)
        pose = res.pose.cpu().numpy()
        frame_ms.append(1000.0 * (time.perf_counter() - t0))
        adds = 1000.0 * evaluation.add_s_error(pose, pose_gt, dense)
        print(f"frame {i}: {frame_ms[-1]:.2f} ms, ADD-S {adds:.3f} mm, "
              f"fitness {float(res.fitness):.4f}, coverage {float(res.coverage):.4f}",
              flush=True)
        check(not res.reinitialized, f"frame {i} re-initialized")
        check(pose.shape == (4, 4) and bool(np.isfinite(pose).all()),
              f"frame {i}: pose not finite")
        check(adds < 5.0, f"frame {i}: ADD-S {adds:.3f} mm >= 5 mm")
    launches = knn_cuda.nn_gather_batched.launches
    check(launches > 0, "the tracked frames never launched K1")
    steady = sum(frame_ms[1:]) / len(frame_ms[1:])
    print(f"Tracker.step: {steady:.2f} ms/frame (frames 1-4; frame 0 "
          f"{frame_ms[0]:.2f} ms), {launches} K1 launches in 5 frames", flush=True)
    # one more frame under torch.profiler: device kernel time against the
    # frame's wall time gives the card's idle share
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tracker.step(depth, hand_base, hand_q)
        torch.cuda.synchronize()
        wall_ms = 1000.0 * (time.perf_counter() - t0)
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
    return launches


def main() -> int:
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
    print(smi, flush=True)

    t0 = time.perf_counter()
    _, log = knn_cuda.build()
    print(f"K1 built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)

    max_err, k_ms, p_ms = kernel_phase(knn_cuda, dev)
    launches = main_path_phase(dev)

    print(json.dumps({"kernels": [{
        "name": "nn_gather_batched", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
