"""Command line of the port (counterpart of cli.py): loops over a recorded
sequence and writes per-frame poses.

    python -m icra20_hand_object_pose_tpu_torch.cli track \
        --data <seq_dir> --object mesh.obj [--config cfg.yaml] --out out/
    python -m icra20_hand_object_pose_tpu_torch.cli demo  [--frames 8] [--out out/]
    python -m icra20_hand_object_pose_tpu_torch.cli eval  --poses out/metrics.jsonl \
        --data <seq_dir> --object mesh.obj [--ref-poses other/poses]
    python -m icra20_hand_object_pose_tpu_torch.cli sweep \
        --data <seq_dir_0> --object mesh_0.obj --data <seq_dir_1> --object mesh_1.obj \
        [--config cfg.yaml] --out out_sweep/
    torchrun --nproc-per-node 2 -m icra20_hand_object_pose_tpu_torch.cli sweep \
        --shard --data ... --object ... --out out_sweep/
    python -m icra20_hand_object_pose_tpu_torch.cli bench

Outputs: per-frame 4x4 pose text files, a structured metrics.jsonl, and a
summary table. `--device` picks where the models and frames live (default
`cuda`; `cpu` for a machine without a card). `--profile DIR` wraps the run
in a torch.profiler trace and writes it to DIR as a Chrome trace. `sweep`
tracks a model library, one sequence per object, all objects stepped as one
batched program (parallel.LibrarySweep); with `--shard` under torchrun the
objects are split over the ranks (one per card over NCCL with `--device
cuda`, gloo ranks with `--device cpu`) and rank 0 writes the files a
one-process run writes. `bench` prints the headline
benchmark's JSON line (benchmarks.main; `bench_torch.py` at the repo root
runs the other modes).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time

import numpy as np


def _load_cfg(args, camera=None):
    from .utils.config import EstimatorConfig, load_yaml

    if getattr(args, "config", None):
        cfg = load_yaml(args.config)
    else:
        cfg = EstimatorConfig()
    if camera is not None:
        cfg = dataclasses.replace(cfg, camera=camera)
    return cfg


def _make_hand(cfg, device):
    from .models import load_hand_spec, make_model_o_hand, make_t42_hand

    if not cfg.hand.enabled:
        return None
    spec = cfg.hand.spec
    if spec in ("", "t42"):
        return make_t42_hand(device=device)
    if spec == "model_o":
        return make_model_o_hand(device=device)
    return load_hand_spec(spec, device=device)


def _track_frames(est, frames, out_dir, log_every=1, overlays=False):
    """Shared tracking loop: frames is an iterable of objects with
    .depth/.hand_base/.hand_q/.pose_gt (pose_gt optional). The timed span
    is Tracker.step up to the pose on the host; metrics, pose files and
    overlays are written outside it."""
    from .evaluation import (
        JsonlLogger, add_s_error, evaluate_trajectory, translation_error,
    )
    from .models import Tracker

    os.makedirs(out_dir, exist_ok=True)
    pose_dir = os.path.join(out_dir, "poses")
    os.makedirs(pose_dir, exist_ok=True)
    if overlays:
        from .visualize import save_overlay
        ov_dir = os.path.join(out_dir, "overlays")
        os.makedirs(ov_dir, exist_ok=True)
    tracker = Tracker(est)
    est_poses, gt_poses = [], []
    model_pts = est.obj.model_pts.cpu().numpy()
    t_total = 0.0
    with JsonlLogger(os.path.join(out_dir, "metrics.jsonl")) as log:
        for i, fr in enumerate(frames):
            t0 = time.perf_counter()
            out = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
            pose = out.pose.cpu().numpy()
            dt = time.perf_counter() - t0
            t_total += dt
            est_poses.append(pose)
            np.savetxt(os.path.join(pose_dir, f"{i:06d}.txt"), pose, fmt="%.9g")
            rec = dict(
                frame=i, ms=dt * 1000.0,
                fitness=float(out.fitness), coverage=float(out.coverage),
                reinitialized=bool(out.reinitialized),
                pose=pose,
            )
            if fr.pose_gt is not None:
                gt_poses.append(np.asarray(fr.pose_gt))
                rec["add_s"] = add_s_error(pose, fr.pose_gt, model_pts)
                rec["trans_err"] = translation_error(pose, fr.pose_gt)
            log.log(**rec)
            if overlays:
                save_overlay(
                    os.path.join(ov_dir, f"overlay_{i:06d}.png"),
                    np.asarray(fr.depth), pose, est.obj, est.cfg.camera,
                    hand=est.hand, hand_base=fr.hand_base, hand_q=fr.hand_q,
                    rgb=getattr(fr, "rgb", None),
                )
            if log_every and i % log_every == 0:
                extra = (
                    f" ADD-S={rec['add_s']*1000:.2f}mm" if "add_s" in rec else ""
                )
                print(
                    f"frame {i}: {dt*1000:.0f}ms fit={rec['fitness']:.3f}"
                    f" cov={rec['coverage']:.3f}"
                    f"{' REINIT' if rec['reinitialized'] else ''}{extra}",
                    flush=True,
                )
    summary = None
    if gt_poses and len(gt_poses) == len(est_poses):
        summary = evaluate_trajectory(
            est_poses, gt_poses, model_pts, est.obj.diameter,
            mesh=est.obj.mesh,
        )
        print(summary)
        with open(os.path.join(out_dir, "summary.json"), "w") as f:
            json.dump(summary.to_dict(), f, indent=2)
    n = len(est_poses)
    print(f"{n} frames in {t_total:.2f}s ({t_total/max(n,1)*1000:.0f} ms/frame)"
          f" -> {out_dir}")
    return summary


def cmd_track(args):
    from .datasets.sequence import RecordedSequence
    from .models import Estimator, ObjectModel

    seq = RecordedSequence(args.data)
    cfg = _load_cfg(args, camera=seq.camera)
    obj = ObjectModel.load(args.object, model_points=cfg.model_points,
                           device=args.device)
    est = Estimator(obj, _make_hand(cfg, args.device), cfg)
    _track_frames(est, seq, args.out, overlays=args.overlays)
    return 0


def demo_config(args):
    """(camera, EstimatorConfig) of `demo`: a camera of args.width x
    args.height with fx = fy = 0.9 width, the YAML or default configuration
    on it, and with --particles N a swarm of N and an init swarm of 2N."""
    from .utils.config import CameraIntrinsics

    cam = CameraIntrinsics(width=args.width, height=args.height,
                           fx=0.9 * args.width, fy=0.9 * args.width,
                           cx=args.width / 2, cy=args.height / 2)
    cfg = _load_cfg(args, camera=cam)
    if args.particles:
        cfg = dataclasses.replace(
            cfg,
            pso=dataclasses.replace(cfg.pso, particles=args.particles),
            tracker=dataclasses.replace(
                cfg.tracker, reinit_particles=2 * args.particles
            ),
        )
    return cam, cfg


def cmd_demo(args):
    """Self-contained: synthesize a grasp sequence, save it in the
    recorded layout, track it back through the full I/O path."""
    from .datasets import SyntheticSequenceConfig, generate_sequence
    from .datasets.sequence import RecordedSequence, save_sequence
    from .models import Estimator, ObjectModel
    from .utils import meshio

    cam, cfg = demo_config(args)
    mesh = meshio.make_test_object(args.shape)
    hand = _make_hand(cfg, args.device)
    frames = generate_sequence(
        mesh, hand, SyntheticSequenceConfig(n_frames=args.frames, camera=cam),
        device=args.device,
    )
    seq_dir = os.path.join(args.out, "sequence")
    save_sequence(frames, cam, seq_dir)
    seq = RecordedSequence(seq_dir)
    obj = ObjectModel(mesh, model_points=cfg.model_points, device=args.device)
    est = Estimator(obj, hand, cfg)
    _track_frames(est, seq, args.out, overlays=args.overlays)
    return 0


def cmd_eval(args):
    from .datasets.sequence import RecordedSequence
    from .evaluation import evaluate_trajectory
    from .models import ObjectModel
    from .parity import compare_pose_sequences, load_pose_dump

    if not os.path.exists(args.poses):
        print(f"error: --poses path not found: {args.poses}", file=sys.stderr)
        return 2
    seq = RecordedSequence(args.data)
    obj = ObjectModel.load(args.object, device=args.device)
    model_pts = obj.model_pts.cpu().numpy()
    est_poses = load_pose_dump(args.poses)
    if getattr(args, "ref_poses", None):
        # parity against another implementation's pose dump (parity.py)
        rep = compare_pose_sequences(
            est_poses, load_pose_dump(args.ref_poses), model_pts,
        )
        print(rep)
    gt = [seq[i].pose_gt for i in range(len(seq))]
    if any(g is None for g in gt):
        print("sequence has no ground truth", file=sys.stderr)
        return 1
    summary = evaluate_trajectory(
        est_poses, gt, model_pts, obj.diameter, mesh=obj.mesh
    )
    print(summary)
    print(json.dumps(summary.to_dict()))
    return 0


def _sweep_mesh(args):
    """(mesh, device, whether this process joined a process group) for
    `sweep`: with --shard, the object mesh over the ranks of the process
    group that the caller, or torchrun (WORLD_SIZE), set up; else none."""
    import torch
    import torch.distributed as dist

    from .parallel import make_mesh

    device = torch.device(args.device)
    if not args.shard:
        return None, device, False
    joined = False
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:
        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        joined = True
    if dist.is_initialized():
        return make_mesh(axis_name="obj"), device, joined
    return None, device, False


def cmd_sweep(args):
    """Track a model library concurrently: one sequence per object, all
    stepped as one batched program (LibrarySweep), the objects split over
    the ranks with --shard under torchrun. Writes obj<i>_poses/<frame>.txt
    per object and one metrics.jsonl record per frame (rank 0 alone on a
    mesh)."""
    import torch
    import torch.distributed as dist

    if len(args.data) != len(args.object):
        print(f"error: {len(args.data)} sequences vs {len(args.object)} "
              f"objects", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count() if args.device.startswith("cuda") else 0
    if (args.shard and n_cards > 1 and not dist.is_initialized()
            and "WORLD_SIZE" not in os.environ):
        # never one card quietly: a process per card
        print(f"error: --shard over {n_cards} CUDA devices runs one process "
              f"per device: torchrun --nproc-per-node {n_cards} -m "
              f"icra20_hand_object_pose_tpu_torch.cli sweep --shard ...",
              file=sys.stderr)
        return 2
    mesh, device, joined = _sweep_mesh(args)
    try:
        return _sweep(args, mesh, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _sweep(args, mesh, device):
    from .datasets.sequence import RecordedSequence
    from .evaluation import JsonlLogger, add_s_error
    from .models import ObjectModel
    from .parallel import LibrarySweep, is_writer

    seqs = [RecordedSequence(d) for d in args.data]
    cams = {(s.camera.width, s.camera.height, s.camera.fx) for s in seqs}
    if len(cams) != 1:
        print("error: sequences must share camera intrinsics", file=sys.stderr)
        return 2
    n_frames = min(len(s) for s in seqs)
    cfg = _load_cfg(args, camera=seqs[0].camera)
    objs = [
        ObjectModel.load(p, model_points=cfg.model_points, device=device)
        for p in args.object
    ]
    sweep = LibrarySweep(objs, _make_hand(cfg, device), cfg, mesh=mesh)
    st = sweep.init_state()
    # every rank steps; one writes
    writer = is_writer(mesh)
    pose_dirs = [os.path.join(args.out, f"obj{i:02d}_poses")
                 for i in range(len(objs))]
    if writer:
        for d in pose_dirs:
            os.makedirs(d, exist_ok=True)
    model_pts = [o.model_pts.cpu().numpy() for o in objs]
    t_total = 0.0
    with (JsonlLogger(os.path.join(args.out, "metrics.jsonl")) if writer
          else contextlib.nullcontext()) as log:
        for fi in range(n_frames):
            frames = [s[fi] for s in seqs]
            depths = np.stack([np.asarray(f.depth) for f in frames])
            hbs = np.stack([
                np.asarray(f.hand_base) if f.hand_base is not None
                else np.eye(4, dtype=np.float32) for f in frames
            ])
            hq0 = next((f.hand_q for f in frames if f.hand_q is not None), None)
            hqs = (
                np.stack([
                    np.asarray(f.hand_q) if f.hand_q is not None
                    else np.zeros_like(np.asarray(hq0)) for f in frames
                ]) if hq0 is not None else None
            )
            t0 = time.perf_counter()
            st, res = sweep.step(st, depths, hbs, hqs)
            poses = res.poses.cpu().numpy()
            dt = time.perf_counter() - t0
            t_total += dt
            if log is None:
                continue
            rec = dict(frame=fi, ms=dt * 1000.0,
                       fitness=res.fitness.cpu().numpy().tolist(),
                       reinitialized=res.reinitialized.cpu().numpy().tolist())
            adds = []
            for oi, f in enumerate(frames):
                np.savetxt(os.path.join(pose_dirs[oi], f"{fi:06d}.txt"),
                           poses[oi], fmt="%.9g")
                if f.pose_gt is not None:
                    adds.append(add_s_error(poses[oi], f.pose_gt, model_pts[oi]))
            if adds:
                rec["add_s"] = adds
            log.log(**rec)
            extra = (
                " ADD-S[mm]=" + ",".join(f"{a*1000:.1f}" for a in adds)
                if adds else ""
            )
            print(f"frame {fi}: {dt*1000:.0f}ms {len(objs)} objects{extra}",
                  flush=True)
    if writer:
        print(f"{n_frames} frames x {len(objs)} objects in {t_total:.2f}s "
              f"({t_total/max(n_frames,1)*1000:.0f} ms/frame) -> {args.out}")
    return 0


def cmd_bench(args):
    from . import benchmarks

    benchmarks.main(device=args.device)
    return 0


def _profiled(fn, args, out_dir: str):
    """Run fn(args) under torch.profiler (host, and the card when one is
    in use) and write a Chrome trace into out_dir."""
    from .utils.profiling import trace

    with trace(out_dir, device=args.device):
        return fn(args)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="icra20_hand_object_pose_tpu_torch",
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace to DIR")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_arg(p):
        p.add_argument("--device", default="cuda",
                       help="torch device of the models and frames "
                            "(default cuda; cpu on a machine without a card)")

    p = sub.add_parser("track", help="track an object through a recorded sequence")
    p.add_argument("--data", required=True, help="sequence directory")
    p.add_argument("--object", required=True, help="object mesh (.obj/.ply)")
    p.add_argument("--config", default=None, help="YAML config")
    p.add_argument("--out", default="out", help="output directory")
    p.add_argument("--overlays", action="store_true",
                   help="save per-frame overlay PNGs")
    device_arg(p)
    p.set_defaults(fn=cmd_track)

    p = sub.add_parser("demo", help="synthetic grasp sequence end-to-end")
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--shape", default="box",
                   choices=["box", "cylinder", "sphere"])
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--particles", type=int, default=None)
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="out_demo")
    p.add_argument("--overlays", action="store_true",
                   help="save per-frame overlay PNGs")
    device_arg(p)
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("eval", help="score saved poses against ground truth")
    p.add_argument("--poses", required=True,
                   help="metrics.jsonl or a directory of 4x4 .txt files")
    p.add_argument("--data", required=True)
    p.add_argument("--object", required=True)
    p.add_argument("--ref-poses", default=None,
                   help="reference pose dump (dir/.jsonl/.txt/.npy) for a "
                        "parity report vs another implementation")
    device_arg(p)
    p.set_defaults(fn=cmd_eval)

    p = sub.add_parser(
        "sweep", help="track a model library concurrently (one batched program)"
    )
    p.add_argument("--data", action="append", required=True,
                   help="sequence directory (repeat, one per object)")
    p.add_argument("--object", action="append", required=True,
                   help="object mesh (repeat, paired with --data by order)")
    p.add_argument("--config", default=None)
    p.add_argument("--out", default="out_sweep")
    p.add_argument("--shard", action="store_true",
                   help="shard the object axis over the ranks of torchrun "
                        "(one per device); a lone process runs unsharded")
    device_arg(p)
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("bench", help="run the headline benchmark")
    device_arg(p)
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.profile:
        return _profiled(args.fn, args, args.profile)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main() or 0)
