"""The whole tracked-frame slice of the port against the JAX package, on
`__graft_entry__._tiny_setup`'s frame and configuration, both started from
the ground-truth prior. The two draw different random numbers, so frames
are compared by dense ADD-S over three seeds each: the port's mean must be
within max(reference mean + 3 mm, 5 mm)."""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu import evaluation
from icra20_hand_object_pose_tpu.models import Estimator as JaxEstimator
from icra20_hand_object_pose_tpu.ops import pso as jpso
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch import convert
from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
from icra20_hand_object_pose_tpu_torch.ops import pso

torch.set_num_threads(2)
SEEDS = (0, 1, 2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def setup():
    import __graft_entry__ as ge

    cfg, obj, hand, frame = ge._tiny_setup()
    tobj = convert.object_from_numpy(
        **{f: np.asarray(getattr(obj, f)) for f in (
            "model_pts", "model_normals", "render_pts", "render_normals",
            "render_w", "symmetries")},
        diameter=obj.diameter, mesh=obj.mesh, device="cpu",
    )
    thand = convert.hand_from_numpy(
        link_pts=np.asarray(hand._link_pts),
        link_normals=np.asarray(hand._link_normals),
        origins=np.asarray(hand._origins), links=hand.links,
        n_joints=hand.n_joints, device="cpu",
    )
    dense, _ = obj.mesh.sample_surface(4096, seed=5)
    return cfg, obj, hand, frame, Estimator(tobj, thand, cfg), dense


def _adds_mm(pose, frame, dense):
    return 1000.0 * evaluation.add_s_error(np.asarray(pose), frame.pose_gt, dense)


def test_tracked_frame_matches_reference(setup):
    cfg, obj, hand, frame, est, dense = setup
    ref_est = JaxEstimator(obj, hand, cfg)
    ref = [
        _adds_mm(ref_est.estimate(
            jnp.asarray(frame.depth), jnp.asarray(frame.pose_gt),
            jnp.asarray(frame.hand_base), jnp.asarray(frame.hand_q),
            key=jax.random.key(s), mode="track").pose, frame, dense)
        for s in SEEDS
    ]
    port = []
    for s in SEEDS:
        out = est.estimate(frame.depth, frame.pose_gt, frame.hand_base,
                           frame.hand_q, key=s, mode="track")
        assert torch.isfinite(out.pose).all() and torch.isfinite(out.fitness)
        assert out.fitness_trace.shape == (cfg.pso.iters,)
        assert out.hyp_poses.shape == (1, 4, 4)
        port.append(_adds_mm(out.pose, frame, dense))
    print(f"ADD-S mm: reference {np.round(ref, 2)}, port {np.round(port, 2)}")
    assert np.mean(port) <= max(np.mean(ref) + 3.0, 5.0), (ref, port)


def _variant(cfg, name):
    """Track-mode configurations beyond the default one."""
    import dataclasses as dc

    if name == "motion_prior":
        return dc.replace(cfg, tracker=dc.replace(cfg.tracker, motion_prior=1.0))
    if name == "two_hypotheses":
        return dc.replace(cfg, tracker=dc.replace(cfg.tracker, n_hypotheses=2))
    if name == "lowres_upsampled_hand_mask":
        return dc.replace(cfg, render_size=cfg.camera.height // 2,
                          hand=dc.replace(cfg.hand, full_res_mask=False))
    if name == "no_hand":
        return dc.replace(cfg, hand=dc.replace(cfg.hand, enabled=False))
    return cfg


@pytest.mark.parametrize("variant", ["default", "motion_prior", "two_hypotheses",
                                     "lowres_upsampled_hand_mask", "no_hand"])
def test_tracker_steps_from_seeded_state(setup, variant):
    cfg, _, _, frame, est, dense = setup
    if variant != "default":
        est = Estimator(est.obj, est.hand, _variant(cfg, variant))
    tracker = Tracker(est, seed=0)
    tracker.state = tracker.state._replace(
        pose=frame.pose_gt, initialized=True, fitness=1.0)
    # three steps: the third is the first with a velocity (two tracked poses)
    for i in range(3):
        res = tracker.step(frame.depth, frame.hand_base, frame.hand_q)
        assert not res.reinitialized and res.frame_idx == i
        assert torch.isfinite(res.pose).all()
        assert _adds_mm(res.pose, frame, dense) < 10.0
    assert tracker.state.frame_idx == 3 and tracker.state.pose_tracked
    assert tracker.state.prev_pose is not None
    n_hyp = cfg.tracker.n_hypotheses if variant != "two_hypotheses" else 2
    assert (tracker.state.hyp_poses is None) == (n_hyp == 1)


def test_snap_and_hypotheses_match_reference(setup):
    _, obj, *_ = setup
    g = np.random.default_rng(0)
    xi = np.concatenate([g.normal(size=(6, 3)) * 0.6,
                         g.normal(size=(6, 3)) * 0.03], -1).astype(np.float32)
    cands = np.array(jse3.se3_exp(jnp.asarray(xi)))
    cands[:, 2, 3] += 0.5
    fit = g.random(6).astype(np.float32)
    sym, mpts = np.asarray(obj.symmetries), np.asarray(obj.model_pts)
    for i in range(1, 6):
        ref = jpso.snap_to_branch(jnp.asarray(cands[i]), jnp.asarray(cands[0]),
                                  jnp.asarray(sym), jnp.asarray(mpts))
        out = pso.snap_to_branch(torch.tensor(cands[i]), torch.tensor(cands[0]),
                                 torch.tensor(sym), torch.tensor(mpts))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    ref_p, ref_f = jpso.diverse_hypotheses(jnp.asarray(cands), jnp.asarray(fit), 3)
    out_p, out_f = pso.diverse_hypotheses(torch.tensor(cands), torch.tensor(fit), 3)
    np.testing.assert_allclose(out_p.numpy(), np.asarray(ref_p), atol=1e-6)
    np.testing.assert_array_equal(out_f.numpy(), np.asarray(ref_f))


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import icra20_hand_object_pose_tpu_torch as p\n"
        "from icra20_hand_object_pose_tpu_torch import convert, evaluation\n"
        "from icra20_hand_object_pose_tpu_torch import datasets, models, ops, utils\n"
        "from icra20_hand_object_pose_tpu_torch.ops import icp, knn_cuda, pso\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('icra20_hand_object_pose_tpu.'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
