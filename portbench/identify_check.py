"""The plain reference of library identification (reference/identify.py)
held against the steps the program served: every program call of a
recorded step replayed eagerly on the same seeds (`_sweep_step`, which
must give the program's result bit for bit), the frame as the program
prepared it captured in that replay (its full-resolution depth, validity,
neutral and hand images, its scene cloud and weights), and every candidate
re-scored by the reference at the pose the step served. `judge` then runs
the reference's own rule over the reference's scores from the first
recorded step on (its own sums, its own lead) and holds the program's
named candidate and sums to it: record from the state's first step.

Imports the program, so it lives outside reference/; `chip_smoke.py` runs it
on the card and the tests on the CPU.

    rec = Recorder(loop)              # loops/identify.py's Loop
    rec.on = True                     # record the steps served from now
    loop.serve(i) ...
    steps = judge([rescore(loop.sweep, s) for s in rec.steps], tol)
"""
from __future__ import annotations

import torch

from .reference import identify as ref


class Recorder:
    """Records the steps of an identify loop while `on`: the state before
    and after each step, each program call's arguments and result, the
    step's result."""

    def __init__(self, loop):
        self.on = False
        self.steps: list = []
        self._calls: list = []
        sweep, run, entry = loop.sweep, loop.sweep._run, loop.entry

        def recorded_run(keys, depths, prev, hand_bases, hand_qs, mode):
            out = run(keys, depths, prev, hand_bases, hand_qs, mode)
            if self.on:
                self._calls.append(dict(keys=list(keys), depths=depths, prev=prev,
                                        hand_bases=hand_bases, hand_qs=hand_qs,
                                        mode=mode, out=out))
            return out

        def recorded_entry(sw, state, *frame):
            self._calls = []
            new, res = entry(sw, state, *frame)
            if self.on:
                self.steps.append(dict(state=state, after=new, calls=self._calls,
                                       result=res))
            return new, res

        sweep._run = recorded_run
        loop.entry = recorded_entry


def replay(sweep, call: dict):
    """`call` run eagerly through `_sweep_step` on generators of its seeds:
    (its result, the frame as it prepared it: `_stack_preps`' result)."""
    from icra20_hand_object_pose_tpu_torch.models.estimator import _generator
    from icra20_hand_object_pose_tpu_torch.utils import rng

    dev, est = sweep.device, sweep._est
    gens = rng.Stack([_generator(k, dev) for k in call["keys"]])
    inputs = [torch.as_tensor(call[k], dtype=torch.float32, device=dev)
              for k in ("depths", "prev", "hand_bases", "hand_qs")]
    seen, real = [], est._stack_preps

    def stack(preps):
        seen.append(real(preps))
        return seen[-1]

    est._stack_preps = stack
    try:
        with torch.no_grad():
            out = type(sweep)._sweep_step(sweep, gens, *inputs, **sweep._statics(call["mode"]))
    finally:
        del est._stack_preps
    return out, seen[0]


def same(a, b) -> list[str]:
    """The fields of two results that part (not bitwise equal)."""
    return [name for name, x, y in zip(a._fields, a, b)
            if (x is None) != (y is None) or (x is not None and not torch.equal(x, y))]


def reference_scores(sweep, prep, poses) -> list:
    """Each candidate's identification score by the reference at its pose
    (poses [O,4,4]) on the prepared frame `prep`."""
    sc, cam = sweep.cfg.score, sweep.cfg.camera
    scene, weights, _, hand, _ = prep
    model_pts, _, render_pts, render_normals = sweep._obj_tensors[:4]
    frame = dict(depth=scene.depth_full[0], valid=scene.valid_full[0],
                 neutral=scene.neutral_full[0], hand=hand[0], scene=scene.points[0],
                 weights=weights[0], fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy)
    params = dict(depth_tau=sc.depth_tau_fine if sc.depth_tau_fine > 0 else sc.depth_tau,
                  wrong_side_penalty=sc.wrong_side_penalty,
                  occlusion_margin=sc.occlusion_margin, invalid_penalty=sc.invalid_penalty,
                  ghost_dilate=sc.ghost_dilate, coverage_weight=sc.coverage_weight,
                  scene_cov_weight=sc.scene_cov_weight, scene_cov_tau=sc.scene_cov_tau)
    return [float(ref.score(dict(pose=poses[o], samples=render_pts[o],
                                 normals=render_normals[o], model=model_pts[o]),
                            frame, params))
            for o in range(poses.shape[0])]


def rescore(sweep, step: dict) -> dict:
    """One recorded step re-scored: `parting` (the result fields of each
    program call that part from its eager replay), `port` (each
    candidate's identification score), `reference` (the reference's at the
    pose the step served, on the frame as the call that served the
    candidate prepared it), and the program's `named` and `sums` (its
    summed scores after the step)."""
    res = step["result"]
    restarted = res.reinitialized.cpu()
    ref_score, parting = [None] * len(restarted), []
    for call in step["calls"]:
        eager, prep = replay(sweep, call)
        parting.append(same(call["out"], eager))
        for o, f in enumerate(reference_scores(sweep, prep, res.poses)):
            if bool(restarted[o]) == (call["mode"] == "init"):
                ref_score[o] = f
    return dict(parting=parting, port=res.score.tolist(), reference=ref_score,
                named=int(res.named), sums=step["after"].score_sum.tolist(),
                restarted=restarted.tolist())


def judge(steps: list, tol: float) -> list:
    """The reference's rule run over the reference's scores of `steps`
    (rescore's, from the state's first step on), each step given
    `reference_named`, `reference_sums`, `lead` (the reference's best sum
    over the next best) and `judged`: whether the lead lies more than the
    scores' summed tolerance (`tol` a candidate a step, twice: either sum
    may be off by it) from the rule's LEAD, so that the program has to name
    as the reference does."""
    sums = None
    for t, step in enumerate(steps):
        named, sums = ref.name(step["reference"], sums)
        best = max(sums)
        rest = sorted(sums)[-2] if len(sums) > 1 else float("-inf")
        step.update(reference_named=named, reference_sums=list(sums), lead=best - rest,
                    judged=abs(best - rest - ref.LEAD) > 2 * (t + 1) * tol)
    return steps
