"""The port's swarm search (`ops/pso.pso`) against the behaviour claims of
`tests/test_pso.py` that no other port test states, at the reference's
sizes, configurations and thresholds:

- `test_pso_recovers_pose`: 16 particles x 4 iterations recover the pose of
  an object-only scene to under 5 mm ADD, fitness above 0.3;
- `test_pso_best_at_gt_survives`: a particle started at the ground truth
  leaves the result under 3 mm ADD;
- `test_pso_no_icp_still_improves`: render-and-compare annealing alone
  (icp_every=0) ends closer than the start;
- `test_slide_proposals_escape_axial_fixed_point`: a pose slid along the
  box's long axis is an exact point-to-plane fixed point once the end faces
  leave the ICP cloud; the axial-slide candidates recover it (< 10 mm) and
  without them the run stays stuck (> 25 mm).

The scenes are the reference test's own (`test_pso.make_problem` and the
slide test's clouds, built with the JAX package on the CPU), handed to the
port as arrays. Draws that fix the scenario come from the reference's keys
too: the initial swarm is the JAX package's `perturb_pose` over
`split(key, particles)`. The search draws its own stream from a
`torch.Generator` seeded with the reference's key integer.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from icra20_hand_object_pose_tpu.ops import render as jrender
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.ops import pso
from icra20_hand_object_pose_tpu_torch.utils import rng, se3
from icra20_hand_object_pose_tpu_torch.utils.config import (
    IcpConfig, PsoConfig, ScoreConfig,
)

import test_pso as ref

torch.set_num_threads(2)
CAM = ref.CAM
SCENE = ("scene_pts", "scene_normals", "scene_weights", "model_pts",
         "model_normals", "render_pts", "render_normals", "render_w", "obs",
         "obs_valid", "hand_depth")


def _t(a):
    a = np.asarray(a)
    return torch.tensor(a if a.dtype == bool else a.astype(np.float32))


def _gen(seed: int) -> rng.Stack:
    return rng.Stack([torch.Generator().manual_seed(seed)])


def _pso(seed, poses0, scene: dict, **cfgs):
    """pso.pso of one object (the library form at O = 1) on the reference
    scene `scene` from the swarm `poses0` [P,4,4], with the model cloud's
    principal axis as ObjectModel computes it; returns its result with the
    object axis dropped."""
    args = [_t(scene[k])[None] for k in SCENE]
    axis, extent = pso.principal_axis(_t(scene["model_pts"]))
    res = pso.pso(_gen(seed), _t(poses0)[None], *args, splat_radius=1, **CAM,
                  slide_axes=(axis[None], extent[None]), **cfgs)
    return pso.PsoResult(*(t[0] for t in res))


def _swarm(p, key, particles):
    """The reference's initial swarm: perturb_pose of T0 over split(key,
    particles)."""
    return np.asarray(jax.vmap(lambda k: jse3.perturb_pose(k, p["T0"], 0.05, 0.01))(
        jax.random.split(key, particles)))


def run_pso(p, seed, particles=16, iters=4, **over):
    """test_pso.run_pso on the port: the swarm from key(seed), the search's
    stream from seed."""
    cfgs = dict(
        pso_cfg=PsoConfig(
            particles=particles, iters=iters, rot_sigma=0.08, trans_sigma=0.01,
            sigma_decay=0.7, icp_every=1, icp_iters_inner=4, elite_frac=0.25,
        ),
        icp_cfg=IcpConfig(iters=10, max_corresp_dist=0.05),
        score_cfg=ScoreConfig(),
    )
    cfgs.update(over)
    return _pso(seed, _swarm(p, jax.random.key(seed), particles), p, **cfgs)


def _add(pose, p):
    return float(se3.add_error(pose, _t(p["T_gt"]), _t(p["model_pts"])))


def test_pso_recovers_pose():
    p = ref.make_problem(jax.random.key(0))
    res = run_pso(p, 1)
    add = _add(res.best_pose, p)
    assert add < 0.005, f"ADD {add*1000:.2f}mm"
    assert float(res.best_fitness) > 0.3


def test_pso_best_at_gt_survives():
    """If a particle starts exactly at GT, the result cannot be worse."""
    p = ref.make_problem(jax.random.key(4))
    particles = 8
    poses0 = np.asarray(jnp.broadcast_to(p["T0"], (particles, 4, 4)).at[3].set(p["T_gt"]))
    res = _pso(
        5, poses0, p,
        pso_cfg=PsoConfig(particles=particles, iters=3, icp_every=1,
                          icp_iters_inner=3, elite_frac=0.25),
        icp_cfg=IcpConfig(iters=5),
        score_cfg=ScoreConfig(),
    )
    assert _add(res.best_pose, p) < 0.003


def test_pso_no_icp_still_improves():
    """Pure render-and-compare annealing (icp_every=0) should still reduce
    error vs the initial hypothesis."""
    p = ref.make_problem(jax.random.key(6), rot_deg=8.0, trans=0.015)
    res = run_pso(
        p, 7, particles=32, iters=6,
        pso_cfg=PsoConfig(particles=32, iters=6, rot_sigma=0.08,
                          trans_sigma=0.01, icp_every=0, elite_frac=0.25),
    )
    add0 = _add(_t(p["T0"]), p)
    add1 = _add(res.best_pose, p)
    assert add1 < add0


def test_slide_proposals_escape_axial_fixed_point():
    """PsoConfig.slide_proposals: with the end faces out of the ICP cloud an
    axial slide is an exact point-to-plane fixed point; the axial-slide
    candidates probe the true basin and the fine-tier argmax (which sees
    the whole observed image) picks it up. With slide_proposals=0 the run
    must stay stuck."""
    mesh = jmeshio.make_test_object("box")          # extents (.05,.05,.12)
    mpts, mnrm = mesh.sample_surface(512, seed=0)
    rpts, rnrm = mesh.sample_surface(512, seed=1)
    rw = np.ones(512, np.float32)
    T_gt = np.asarray(jse3.make_pose(jnp.eye(3), jnp.asarray([0.0, 0.0, 0.4])))
    # ICP sees only the side surfaces; the observed IMAGE holds the whole box
    obs = jrender.splat_depth(jse3.transform_points(T_gt, jnp.asarray(rpts)),
                              jnp.asarray(rw), radius=1, **CAM)
    obs_valid = jnp.isfinite(obs)
    scene = dict(
        scene_pts=jse3.transform_points(T_gt, jnp.asarray(mpts)),
        scene_normals=jse3.rotate_vectors(T_gt, jnp.asarray(mnrm)),
        scene_weights=(np.abs(mpts[:, 2]) < 0.045).astype(np.float32),
        model_pts=mpts, model_normals=mnrm, render_pts=rpts, render_normals=rnrm,
        render_w=rw, obs=jnp.where(obs_valid, obs, 0.0), obs_valid=obs_valid,
        hand_depth=np.full((CAM["height"], CAM["width"]), np.inf, np.float32))

    slide = 0.04                                   # meters, along model z
    T0 = T_gt.copy()
    T0[:3, 3] += T_gt[:3, :3] @ np.asarray([0.0, 0.0, slide], np.float32)
    poses0 = np.broadcast_to(T0, (4, 4, 4))

    def run(n_slide):
        res = _pso(
            8, poses0, scene,
            pso_cfg=PsoConfig(
                particles=4, iters=1, rot_sigma=1e-4, trans_sigma=1e-5,
                icp_every=0, elite_frac=0.25, polish_top_k=2,
                finish_iters=0, slide_proposals=n_slide,
            ),
            icp_cfg=IcpConfig(iters=6, max_corresp_dist=0.02),
            score_cfg=ScoreConfig(),
        )
        return float(se3.add_error(res.best_pose, _t(T_gt), _t(mpts)))

    add_stuck = run(0)
    add_slide = run(8)
    assert add_stuck > 0.025, f"baseline unexpectedly recovered: {add_stuck}"
    assert add_slide < 0.010, f"slide proposals failed: {add_slide}"
