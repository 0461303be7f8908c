"""Init mode of the port against the JAX package: the hand-base refinement
with the reference's own random draws injected, init frames of
`__graft_entry__._tiny_setup` (default and fused-GN configurations), and
the Tracker's cold start, forced re-initialisation and hand-base
correction.

Tolerances: refine_base's winning base within 1e-5 (the agreement scores
agree to ~1e-5, test_torch_render_hand.py). Init frames draw different
random numbers on the two sides, so they are held by their outcome over
SEEDS: success (dense ADD-S < 10% of the diameter, the rule of
tests/test_init_success.py) counts may differ by at most one, and the
port's mean ADD-S must stay within INIT_MEAN_TOL_MM of the reference's.

INIT_MEAN_TOL_MM was measured first, with tests/port_init_parity.py: over
64 seeds of this frame the reference succeeded 29/64 (mean 12.06 mm) and
the port 23/64 (13.35 mm); with fused GN 23/64 (13.27 mm) and 23/64
(13.82 mm). At this 64x48 size one init is close to a coin flip between
~4 mm and ~18 mm on both sides, so the port-minus-reference mean over 3
consecutive seeds spreads with a standard deviation of 5.1-5.3 mm and a
95th percentile of 9.2-9.6 mm: the tolerance is 10 mm.
"""
import dataclasses as dc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu import evaluation
from icra20_hand_object_pose_tpu.models import Estimator as JaxEstimator
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.ops import icp as jicp
from icra20_hand_object_pose_tpu.ops import knn as jknn
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch import convert
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp, render_frame_fast,
)
from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
from icra20_hand_object_pose_tpu_torch.models.estimator import FrameResult
from icra20_hand_object_pose_tpu_torch.utils import meshio, rng
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

torch.set_num_threads(2)
SEEDS = (0, 1, 2)
INIT_MEAN_TOL_MM = 10.0


def _hand_to_port(hand):
    return convert.hand_from_numpy(
        link_pts=np.asarray(hand._link_pts),
        link_normals=np.asarray(hand._link_normals),
        origins=np.asarray(hand._origins), links=hand.links,
        n_joints=hand.n_joints, device="cpu",
    )


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
    dense, _ = obj.mesh.sample_surface(4096, seed=5)
    return cfg, obj, hand, frame, tobj, _hand_to_port(hand), dense


def _adds_mm(pose, frame, dense):
    return 1000.0 * evaluation.add_s_error(np.asarray(pose), frame.pose_gt, dense)


# -- hand-base refinement ------------------------------------------------------

def _refine_draws(key, iters, candidates, n_joints):
    """The reference's refine_base draws, in the order the port takes them."""
    out = []
    for k in jax.random.split(key, iters):
        kb, kq = jax.random.split(k)
        kw, kv = jax.random.split(kb)
        out += [jax.random.normal(kw, (candidates - 1, 3)),
                jax.random.normal(kv, (candidates - 1, 3)),
                jax.random.normal(kq, (candidates, n_joints))]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refine_base_matches_reference_with_injected_draws(seed):
    cam = CameraIntrinsics(width=160, height=120, fx=142.5, fy=142.5,
                           cx=80.0, cy=60.0)
    jhand = jax_t42(points_per_link=64)
    thand = _hand_to_port(jhand)
    pose = default_object_pose()
    hb_true = hand_base_for_grasp(pose)
    q_nom = np.asarray([0.45, 0.45], np.float32)
    depth = render_frame_fast(meshio.make_test_object("box"), pose, thand,
                              hb_true, np.asarray([0.6, 0.6], np.float32), cam,
                              noise_sigma=0.001, rng=np.random.default_rng(seed))
    # a 3 deg / 5 mm mount error about the camera origin
    g = np.random.default_rng(10 + seed)
    w, v = g.normal(size=3), g.normal(size=3)
    xi = np.concatenate([w / np.linalg.norm(w) * np.radians(3.0),
                         v / np.linalg.norm(v) * 0.005]).astype(np.float32)
    hb = (np.asarray(jse3.se3_exp(jnp.asarray(xi))) @ hb_true).astype(np.float32)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy, height=cam.height,
              width=cam.width, iters=3, candidates=16)
    key = jax.random.key(seed)
    ref = jhand.refine_base(key, jnp.asarray(depth), jnp.asarray(depth > 0),
                            jnp.asarray(hb), jnp.asarray(q_nom), **kw)
    draws = rng.Draws(*_refine_draws(key, 3, 16, thand.n_joints))
    out = thand.refine_base(draws, torch.tensor(depth), torch.tensor(depth > 0),
                            torch.tensor(hb), torch.tensor(q_nom), **kw)
    assert len(draws) == 0
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    assert not np.allclose(np.asarray(ref), hb)   # the search moved the base


# -- init frames against the reference ----------------------------------------

def _jnp_gn_oracle(maxd2, min_cos, tau2):
    """The reference's unfused composition (tests/test_knn_pallas.py) as a
    gn_fn for the JAX estimator, which builds its fused kernel only on a
    TPU."""
    def one(scene_c, scene_n, scene_w, rc, rn):
        idx, d2 = jknn.nn(scene_c, rc)
        m, n = rc[idx], rn[idx]
        w = jicp.correspondence_weights(d2, scene_n, n, scene_w,
                                        math.sqrt(maxd2), min_cos)
        r = jnp.sum(n * (scene_c - m), axis=-1)
        J = jnp.concatenate([jnp.cross(m, n), n], axis=-1)
        wJ = J * w[:, None]
        hp = jax.lax.Precision.HIGHEST
        return (jnp.einsum("ni,nj->ij", wJ, J, precision=hp),
                jnp.einsum("ni,n->i", wJ, r, precision=hp), jnp.sum(w),
                jnp.sum(scene_w * (d2 < tau2)), jnp.sum(w * r * r))

    def gn_fn(scene_c, scene_n, scene_w, ref_c, ref_n):
        return jax.vmap(one, in_axes=(None, None, None, 0, 0))(
            scene_c, scene_n, scene_w, ref_c, ref_n)

    gn_fn.maxd2, gn_fn.min_cos, gn_fn.tau2 = float(maxd2), float(min_cos), float(tau2)
    return gn_fn


@pytest.mark.parametrize("fused_gn", [False, True])
def test_init_frames_match_reference(setup, fused_gn):
    cfg, obj, hand, frame, tobj, thand, dense = setup
    cfg = dc.replace(cfg, icp=dc.replace(cfg.icp, fused_gn=fused_gn))
    ref_est = JaxEstimator(obj, hand, cfg)
    est = Estimator(tobj, thand, cfg)
    if fused_gn:
        ref_est.gn_fn = _jnp_gn_oracle(est.gn_fn.maxd2, est.gn_fn.min_cos,
                                       est.gn_fn.tau2)
    args = (frame.depth, np.eye(4, dtype=np.float32), frame.hand_base, frame.hand_q)
    ref = [_adds_mm(ref_est.estimate(*map(jnp.asarray, args),
                                     key=jax.random.key(s), mode="init").pose,
                    frame, dense) for s in SEEDS]
    port = []
    for s in SEEDS:
        out = est.estimate(*args, key=s, mode="init")
        assert torch.isfinite(out.pose).all() and torch.isfinite(out.fitness)
        assert out.fitness_trace.shape == (2 * cfg.pso.iters,)
        assert out.hand_delta.shape == (4, 4)
        port.append(_adds_mm(out.pose, frame, dense))
    limit = 100.0 * obj.diameter                   # 10% of it, in mm
    ok_ref = sum(a < limit for a in ref)
    ok_port = sum(a < limit for a in port)
    print(f"init ADD-S mm (limit {limit:.1f}): reference {np.round(ref, 2)}, "
          f"port {np.round(port, 2)}")
    assert abs(ok_ref - ok_port) <= 1, (ref, port)
    assert np.mean(port) <= np.mean(ref) + INIT_MEAN_TOL_MM, (ref, port)


def test_init_frame_args_match_reference(setup):
    cfg, obj, hand, frame, tobj, thand, _ = setup
    _, static = Estimator(tobj, thand, cfg).frame_args(
        frame.depth, np.eye(4, dtype=np.float32), mode="init")
    _, ref = JaxEstimator(obj, hand, cfg).frame_args(
        jnp.asarray(frame.depth), jnp.eye(4), mode="init")
    for k in ("n_particles", "pso_iters", "resample_after", "prescreen"):
        assert static[k] == ref[k], k
    assert static["init_scoring"] and ref["init_scoring"]
    assert math.isinf(static["roi_radius"])


def test_estimator_builds_gn_fn_from_config(setup):
    cfg, _, _, _, tobj, thand, _ = setup
    assert Estimator(tobj, thand, cfg).gn_fn is None
    est = Estimator(tobj, thand, dc.replace(cfg, icp=dc.replace(cfg.icp, fused_gn=True)))
    assert est.gn_fn.maxd2 == cfg.icp.max_corresp_dist ** 2
    assert est.gn_fn.min_cos == math.cos(math.radians(cfg.icp.normal_angle_max_deg))
    assert est.gn_fn.tau2 == cfg.score.scene_cov_tau ** 2
    # nn_fn replaces the default K1 corr_fn
    est = Estimator(tobj, thand, cfg, nn_fn=lambda q, r: None)
    assert est.corr_fn is None and est.nn_fn is not None


# -- the Tracker's watchdog ----------------------------------------------------

@pytest.mark.parametrize("fused_gn", [False, True])
def test_tracker_cold_start_and_forced_reinit(setup, fused_gn):
    cfg, _, _, frame, tobj, thand, _ = setup
    cfg = dc.replace(cfg, icp=dc.replace(cfg.icp, fused_gn=fused_gn))
    tracker = Tracker(Estimator(tobj, thand, cfg), seed=0)
    for i in range(3):
        res = tracker.step(frame.depth, frame.hand_base, frame.hand_q)
        assert res.reinitialized == (i == 0) and res.frame_idx == i
        assert torch.isfinite(res.pose).all()
        st = tracker.state
        assert st.pose_tracked == (i > 0)
        # the velocity restarts after an init, and for one more frame
        assert (st.prev_pose is not None) == (i == 2)
    # accuracy of an init is held by test_init_frames_match_reference
    assert torch.isfinite(res.fitness) and tracker.state.initialized
    assert tracker.state.hand_delta is not None        # auto-armed init frame
    tracker.state = tracker.state._replace(fitness=0.0)    # watchdog fires
    res = tracker.step(frame.depth, frame.hand_base, frame.hand_q)
    assert res.reinitialized and not tracker.state.pose_tracked
    assert tracker.state.prev_pose is None


class _StubEstimator:
    """Records what the Tracker hands the estimator and answers with a fixed
    hand_delta on init frames."""

    def __init__(self, est, delta):
        self.est, self.delta, self.calls = est, delta, []
        self.cfg, self.hand, self.device = est.cfg, est.hand, est.device

    def _tensor(self, x):
        return self.est._tensor(x)

    def estimate(self, depth, prior, hand_base, hand_q, key=None, mode="track"):
        self.calls.append((mode, torch.as_tensor(hand_base).clone()))
        eye = torch.eye(4)
        return FrameResult(
            pose=eye, fitness=torch.tensor(1.0), coverage=torch.tensor(1.0),
            fitness_trace=torch.zeros(1), n_scene=torch.tensor(100.0),
            hyp_poses=eye[None], hyp_fitness=torch.ones(1),
            hand_delta=self.delta if mode == "init" else eye)


def test_tracker_composes_hand_delta(setup):
    cfg, _, _, frame, tobj, thand, _ = setup
    delta = torch.tensor(np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.02, 0.0, 0.003, 0.0, 0.0], jnp.float32))))
    stub = _StubEstimator(Estimator(tobj, thand, cfg), delta)
    tracker = Tracker(stub, seed=0)
    hb = torch.tensor(frame.hand_base)
    tracker.step(frame.depth, hb, frame.hand_q)                  # init
    torch.testing.assert_close(tracker.state.hand_delta, delta)
    tracker.step(frame.depth, hb, frame.hand_q)                  # track
    tracker.state = tracker.state._replace(fitness=0.0)
    tracker.step(frame.depth, hb, frame.hand_q)                  # re-init
    torch.testing.assert_close(tracker.state.hand_delta, delta @ delta)
    modes = [m for m, _ in stub.calls]
    assert modes == ["init", "track", "init"]
    torch.testing.assert_close(stub.calls[0][1], hb)             # uncorrected
    torch.testing.assert_close(stub.calls[1][1], delta @ hb)     # corrected
    torch.testing.assert_close(stub.calls[2][1], delta @ hb)
