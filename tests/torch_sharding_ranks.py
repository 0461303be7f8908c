"""The ranks of tests/test_torch_sharding.py: two gloo processes on the CPU,
started once per test module, that run every sharded case and hand their
results back as numpy arrays. Imports the port and torch only (the test
module imports the JAX package too; a rank needs none of it).

    results = run_ranks(data, world=2, timeout=300)   # [rank 0's, rank 1's]
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np

SHAPES = ["box", "cylinder", "sphere", "ellipsoid"]


def tiny_config():
    """tests/test_sharding.py's tiny configuration (64x48, 16 particles, 3
    iterations, 256 scene points)."""
    from icra20_hand_object_pose_tpu_torch.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
    )

    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    return EstimatorConfig(
        camera=cam, scene_points=256, render_size=48,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=64),
    )


def with_tracker(cfg, **kw):
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **kw))


def models(device="cpu"):
    """The T42 hand and one object per shape, sampled natively (bitwise the
    JAX package's models of the same seeds)."""
    from icra20_hand_object_pose_tpu_torch.models import ObjectModel, make_t42_hand
    from icra20_hand_object_pose_tpu_torch.utils import meshio

    hand = make_t42_hand(points_per_link=64, device=device)
    objs = [ObjectModel(meshio.make_test_object(s), model_points=256,
                        render_points=512, seed=i, device=device)
            for i, s in enumerate(SHAPES)]
    return hand, objs


def sweep_steps(sweep, inputs, forced: int):
    """Init step, track step, then a mixed frame (object `forced`'s fitness
    set to 0): each step's result fields, and the state before the mixed
    frame, as numpy."""
    out, st = [], sweep.init_state()
    for i in range(3):
        if i == 2:
            before = st
            fitness = st.fitness.clone()
            fitness[forced] = 0.0
            st = st._replace(fitness=fitness)
        st, res = sweep.step(st, *inputs)
        out.append({k: v.numpy() for k, v in res._asdict().items() if v is not None})
        out[-1]["vel_ok"] = st.vel_ok.numpy()
        out[-1]["key"] = np.asarray(st.key, np.uint64)
    return out, before


def _cases(rank: int, data: dict) -> dict:
    import torch

    from icra20_hand_object_pose_tpu_torch import cli
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
    from icra20_hand_object_pose_tpu_torch.ops import pso
    from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep, make_mesh

    cfg = tiny_config()
    hand, objs = models()
    fr = data["frames"]
    res: dict = {}

    # the particle axis: a tracked frame split 8 + 8 particles
    mesh_p = make_mesh(2, "p")
    est = Estimator(objs[0], hand, cfg, mesh=mesh_p)
    out = est.estimate(fr["depth"][0], fr["pose_gt"][0], fr["hand_base"][0],
                       fr["hand_q"][0], key=3)
    res["frame"] = {k: getattr(out, k).numpy() for k in ("pose", "fitness", "hyp_poses")}
    two = np.stack([fr["pose_gt"][0], data["offset_pose"]])
    out = est.estimate(fr["depth"][0], two, fr["hand_base"][0], fr["hand_q"][0], key=4)
    res["frame_h2"] = {k: getattr(out, k).numpy()
                       for k in ("pose", "fitness", "hyp_poses", "hyp_fitness")}
    # a Tracker over the split estimator; rank 0 writes its checkpoint
    tracker = Tracker(est, seed=2)
    tracker.state = tracker.state._replace(pose=torch.as_tensor(fr["pose_gt"][0]),
                                           initialized=True, fitness=1.0)
    res["tracker"] = tracker.step(fr["depth"][0], fr["hand_base"][0],
                                  fr["hand_q"][0]).pose.numpy()
    tracker.save(data["tracker_path"])
    errors = []
    bad = dataclasses.replace(cfg, pso=dataclasses.replace(cfg.pso, particles=13))
    few = dataclasses.replace(cfg, pso=dataclasses.replace(cfg.pso, particles=6))
    for c, prev in ((bad, fr["pose_gt"][0]), (few, two)):
        try:
            Estimator(objs[0], hand, c, mesh=mesh_p).estimate(
                fr["depth"][0], prev, fr["hand_base"][0], fr["hand_q"][0])
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    mesh_obj = make_mesh(2, "obj")
    mesh_2d = make_mesh((1, 2), ("obj", "p"))
    for kw in (dict(objects=objs[:3], mesh=mesh_obj),
               dict(objects=objs, cfg=with_tracker(cfg, n_hypotheses=5),
                    mesh=mesh_2d, particle_axis="p")):
        try:
            LibrarySweep(kw.pop("objects"), hand, kw.pop("cfg", cfg), **kw)
            errors.append("")
        except ValueError as e:
            errors.append(str(e))
    res["errors"] = errors

    # the selection over every rank's candidates
    g = torch.Generator().manual_seed(100 + rank)
    from icra20_hand_object_pose_tpu_torch.utils import se3
    cand = se3.perturb_pose(g, torch.as_tensor(fr["pose_gt"][0]), 0.2, 0.02,
                            shape=(5,))[None]                    # [1,5,4,4]
    fit = torch.round(torch.rand((1, 5), generator=g) * 4) / 4  # ties
    cp, cf = pso.gather_candidates(mesh_p.get_group("p"), cand, fit)
    idx = pso.continuity_select(cp, cf, torch.as_tensor(fr["pose_gt"][:1]),
                                objs[0].model_pts[None], eps=0.3)
    res["select"] = dict(cand=cand.numpy(), fit=fit.numpy(), idx=idx.numpy(),
                         pose=pso.pick(cp, idx).numpy())

    # the object axis: 2 objects a rank over an init, a track and a mixed
    # frame; the state before the mixed frame saved for the one-process sweep
    inputs = (fr["depth"], fr["hand_base"], fr["hand_q"])
    sweep = LibrarySweep(objs, hand, cfg, mesh=mesh_obj)
    res["sweep"], before = sweep_steps(sweep, inputs, forced=1)
    sweep.save_state(before, data["state_path"])
    shared = LibrarySweep(objs, hand, cfg, mesh=mesh_obj, shared_scene=True)
    _, r = shared.step(shared.init_state(), fr["depth"][0], fr["hand_base"][0],
                       fr["hand_q"][0])
    res["shared"] = r.poses.numpy()
    # both axes: objects over "obj" (1), each swarm over "p" (2)
    sweep2 = LibrarySweep(objs, hand, cfg, mesh=mesh_2d, particle_axis="p")
    st, r0 = sweep2.step(sweep2.init_state(), *inputs)
    _, r1 = sweep2.step(st, *inputs)
    res["sweep_2d"] = [r0.poses.numpy(), r1.poses.numpy(), r1.fitness.numpy()]

    # the command line, both ranks in the process group
    res["cli"] = cli.main(data["cli_argv"] + ["--shard"])
    return res


def _rank(rank: int, world: int, port: int, data: dict) -> dict:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=120))
    try:
        return _cases(rank, data)
    finally:
        dist.destroy_process_group()


def run_ranks(data: dict, world: int = 2, timeout: float = 300.0) -> list:
    """Start `world` spawned gloo ranks on `data` (parallel.spawn_ranks, one
    OpenMP thread each) and return their results in rank order; a rank that
    fails, or sends nothing in `timeout` seconds, raises."""
    from icra20_hand_object_pose_tpu_torch.parallel import spawn_ranks

    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        return spawn_ranks(_rank, world, (data,), timeout=timeout)
    finally:
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
