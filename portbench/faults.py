"""Faults planted under a run's entry, and the lower-precision control:
what the comparison has to catch. Each is a function of the built loop
that breaks it in place; `calibrate.py` reads them on the card and
`test_portbench_faults.py` sees each turn `correct` false on the CPU. The
benchmark's own runs never apply one.

- `stale`: the step returns its state unchanged (the served pose is the
  one the state held before the frame);
- `half` (a library only): half of the objects left out of the step, the
  rest stepped;
- `lag`: each frame served the pose the entry produced for the frame
  before, while the program's state advances (a pipelined loop that hands
  back the last finished answer);
- `altered`: each served pose altered where it is produced, moved by one
  diameter and turned 60 degrees in the object's frame;
- `control_bf16`: the reference put in the program's place, computed in
  bfloat16, the precision below the configuration's float32: each frame
  served the ground-truth pose rounded to bfloat16. The program still
  serves each frame underneath, its answer set aside, so that the control
  is judged on as many frames as a run.
"""
from __future__ import annotations

import numpy as np
import torch

from .loops import Served
from .reference import geometry


def _alteration(diameter: float) -> np.ndarray:
    A = geometry.se3_exp(np.radians(60.0) * np.ones(3) / np.sqrt(3.0), np.zeros(3))
    A[:3, 3] = diameter * np.array([1.0, -1.0, 1.0]) / np.sqrt(3.0)
    return A


def stale(loop) -> None:
    real = loop.entry
    if hasattr(loop, "sweep"):
        def entry(sweep, state, *frame):
            _, res = real(sweep, state, *frame)
            return state, res._replace(poses=state.poses, fitness=state.fitness,
                                       coverage=state.coverage)
    else:
        def entry(tracker, *frame):
            before = tracker.state
            res = real(tracker, *frame)
            tracker.state = before
            pose = torch.as_tensor(before.pose, dtype=torch.float32,
                                   device=res.pose.device)
            return res._replace(pose=pose)
    loop.entry = entry


def half(loop) -> None:
    real = loop.entry

    def entry(sweep, state, *frame):
        new, res = real(sweep, state, *frame)
        h = state.poses.shape[0] // 2

        def keep(a, b):
            return torch.cat([a[:h], b[h:]])

        poses, fit, cov = (keep(new.poses, state.poses), keep(new.fitness, state.fitness),
                           keep(new.coverage, state.coverage))
        new = new._replace(poses=poses, fitness=fit, coverage=cov)
        return new, res._replace(poses=poses, fitness=fit, coverage=cov)

    loop.entry = entry


def lag(loop) -> None:
    real = loop.entry
    prev = []
    if hasattr(loop, "sweep"):
        def entry(sweep, state, *frame):
            new, res = real(sweep, state, *frame)
            served = res._replace(poses=prev[0]) if prev else res
            prev[:] = [res.poses]
            return new, served
    else:
        def entry(tracker, *frame):
            res = real(tracker, *frame)
            served = res._replace(pose=prev[0]) if prev else res
            prev[:] = [res.pose]
            return served
    loop.entry = entry


def altered(loop) -> None:
    real = loop.entry
    meshes = loop.traffic.meshes
    if hasattr(loop, "sweep"):
        A = torch.as_tensor(np.stack([_alteration(m.diameter()) for m in meshes]),
                            device=loop.sweep.device)

        def entry(sweep, state, *frame):
            new, res = real(sweep, state, *frame)
            return new, res._replace(poses=res.poses @ A)
    else:
        A = torch.as_tensor(_alteration(meshes[0].diameter()), device=loop.est.device)

        def entry(tracker, *frame):
            res = real(tracker, *frame)
            return res._replace(pose=res.pose @ A)
    loop.entry = entry


def control_bf16(loop) -> None:
    t = loop.traffic
    O = len(t.kinds)
    real = loop.serve

    def serve(i: int) -> Served:
        k = real(i).frame
        poses = torch.as_tensor(t.pose_gt[k]).to(torch.bfloat16).to(torch.float32)
        return Served(k, poses.numpy(), np.ones(O, np.float32),
                      np.ones(O, np.float32), np.zeros(O, bool))

    loop.serve = serve


FAULTS = {"stale": stale, "half": half, "lag": lag, "altered": altered}


def applicable(loop_name: str) -> list[str]:
    """The faults a cell of this loop can have."""
    if loop_name == "sweep":
        return ["stale", "half", "lag", "altered"]
    return ["stale", "lag", "altered"]
