"""The port's pixel-mode scorer (`compare_depth`, and `score_particles` under
`ScoreConfig(mode="pixel")`) against the JAX package's on the same seeded
poses and frame: fitness and coverage within 1e-5, the counted pixels
equal. Batched and single renders, with and without the precomputed
`observed_enc`, the hand depth and the sample mask. Then a tracked frame in
pixel mode end to end (16 particles at 64x48)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import pso as jpso
from icra20_hand_object_pose_tpu.ops import render as jrender
from icra20_hand_object_pose_tpu.ops import score as jscore
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch import evaluation
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, default_object_pose, generate_sequence,
    hand_base_for_grasp,
)
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.ops import pso, render, score
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, ScoreConfig, TrackerConfig,
)

torch.set_num_threads(2)

CAM = CameraIntrinsics(width=64, height=48, fx=57.6, fy=57.6, cx=32.0, cy=24.0)
KW = dict(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, height=CAM.height,
          width=CAM.width)
BOX = meshio.make_test_object("box")
T_GT = default_object_pose(0.45)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.fixture(scope="module")
def frame():
    """(observed depth, valid, hand depth, poses [16,4,4], render samples,
    sample mask): a grasp frame with a no-return band and seeded poses."""
    hand = make_t42_hand(points_per_link=64, device="cpu")
    fr = generate_sequence(BOX, hand, SyntheticSequenceConfig(
        n_frames=1, camera=CAM, object_start=T_GT), device="cpu")[0]
    depth = fr.depth.copy()
    depth[20:23, 8:56] = 0.0
    valid = depth > 0.1
    hd = hand.depth(_t(hand_base_for_grasp(T_GT)), _t(fr.hand_q), **KW).numpy()
    g = np.random.default_rng(5)
    xi = np.concatenate([g.normal(size=(16, 3)) * 0.08,
                         g.normal(size=(16, 3)) * 0.01], -1).astype(np.float32)
    xi[0] = 0.0
    poses = np.asarray(jse3.apply_twist_about(
        jnp.asarray(xi), jnp.broadcast_to(jnp.asarray(T_GT), (16, 4, 4)),
        jnp.broadcast_to(jnp.asarray(T_GT[:3, 3]), (16, 3))))
    rpts, rnrm = BOX.sample_surface(600, seed=1)
    mask = g.random(600) > 0.2
    return depth, valid, hd, poses, rpts, rnrm, mask


def _assert_terms(out, ref):
    for f in ("fitness", "coverage"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out.support.numpy(), np.asarray(ref.support),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(out.counted.numpy(), np.asarray(ref.counted))


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("with_enc", [True, False])
@pytest.mark.parametrize("with_hand", [True, False])
def test_compare_depth(frame, batched, with_enc, with_hand):
    depth, valid, hd, poses, rpts, _, _ = frame
    pts = np.einsum("pij,nj->pni", poses[:, :3, :3], rpts) + poses[:, None, :3, 3]
    # one render for both sides: the splats are bitwise equal (see
    # test_torch_render_hand.py), so this compares the scorer alone
    rend = render.splat_depth_batched(_t(pts), torch.ones(len(rpts)), radius=1,
                                      **KW).numpy()
    if not batched:
        rend = rend[3]
    dilate = 2
    kw = dict(depth_tau=0.012, wrong_side_penalty=1.5, occlusion_margin=0.004,
              invalid_penalty=0.25, ghost_dilate=dilate)
    ref = jscore.compare_depth(
        jnp.asarray(rend), jnp.asarray(depth), jnp.asarray(valid),
        jnp.asarray(hd) if with_hand else None,
        observed_enc=(jscore.encode_observed(jnp.asarray(depth), jnp.asarray(valid),
                                             dilate) if with_enc else None), **kw)
    out = score.compare_depth(
        _t(rend), _t(depth), torch.tensor(valid), _t(hd) if with_hand else None,
        observed_enc=(score.encode_observed(_t(depth), torch.tensor(valid), dilate)
                      if with_enc else None), **kw)
    assert out.fitness.shape == ((16,) if batched else ())
    _assert_terms(out, ref)
    assert float(out.counted.min()) >= 10           # the poses see the object
    if with_hand:
        # the hand hides part of the object: fewer pixels carry evidence
        free = score.compare_depth(_t(rend), _t(depth), torch.tensor(valid), **kw)
        assert float((free.counted - out.counted).max()) > 0


def test_compare_depth_no_dilation_and_empty_render(frame):
    depth, valid, hd, *_ = frame
    rend = np.full((2, CAM.height, CAM.width), np.inf, np.float32)
    rend[1, 10:30, 20:40] = 0.45
    kw = dict(ghost_dilate=0)
    ref = jscore.compare_depth(jnp.asarray(rend), jnp.asarray(depth),
                               jnp.asarray(valid), jnp.asarray(hd), **kw)
    out = score.compare_depth(_t(rend), _t(depth), torch.tensor(valid), _t(hd), **kw)
    _assert_terms(out, ref)
    assert float(out.fitness[0]) == -2.0            # nothing visible loses


@pytest.mark.parametrize("masked", [False, True])
def test_score_particles_pixel_mode(frame, masked):
    depth, valid, hd, poses, rpts, rnrm, mask = frame
    cfg = ScoreConfig(mode="pixel")
    w = np.ones(len(rpts), np.float32)
    w[::13] = 0.0
    ref_f, ref_c = jpso.score_particles(
        *map(jnp.asarray, (poses, rpts, rnrm, w, depth, valid, hd)),
        splat_radius=1, score_cfg=cfg,
        observed_enc=jscore.encode_observed(jnp.asarray(depth), jnp.asarray(valid),
                                            cfg.ghost_dilate),
        sample_mask=jnp.asarray(mask) if masked else None, **KW)
    out_f, out_c = pso.score_particles(
        _t(poses), _t(rpts), _t(rnrm), _t(w), _t(depth), torch.tensor(valid), _t(hd),
        splat_radius=1, score_cfg=cfg,
        observed_enc=score.encode_observed(_t(depth), torch.tensor(valid),
                                           cfg.ghost_dilate),
        sample_mask=torch.tensor(mask) if masked else None, **KW)
    np.testing.assert_allclose(out_f.numpy(), np.asarray(ref_f), atol=1e-5, rtol=0)
    np.testing.assert_allclose(out_c.numpy(), np.asarray(ref_c), atol=1e-5, rtol=0)
    assert int(np.argmax(out_f.numpy())) == int(np.argmax(np.asarray(ref_f)))


def test_pixel_mode_tracks_a_frame():
    """ScoreConfig(mode="pixel") through Estimator and Tracker: the scan
    scores splat renders at the render tier, the polish and finisher at the
    camera's resolution."""
    hand = make_t42_hand(points_per_link=64, device="cpu")
    frames = generate_sequence(BOX, hand, SyntheticSequenceConfig(
        n_frames=2, camera=CAM), device="cpu")
    cfg = EstimatorConfig(
        camera=CAM, scene_points=256, render_size=CAM.height // 2,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2,
                      finish_iters=2, finish_particles=32),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=32),
        score=ScoreConfig(mode="pixel"))
    obj = ObjectModel(BOX, model_points=256, render_points=512, device="cpu")
    tracker = Tracker(Estimator(obj, hand, cfg), seed=0)
    tracker.state = tracker.state._replace(pose=_t(frames[0].pose_gt),
                                           initialized=True, fitness=1.0)
    dense, _ = BOX.sample_surface(4096, seed=5)
    for fr in frames:
        out = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
        assert not out.reinitialized and bool(torch.isfinite(out.pose).all())
        assert 0.0 < float(out.coverage) <= 1.0
        adds = 1000.0 * evaluation.add_s_error(out.pose.numpy(), fr.pose_gt, dense)
        assert adds < 10.0, adds
    # an init frame scores its prescreen and swarm in pixel mode too
    out = Estimator(obj, hand, cfg).estimate(
        frames[0].depth, np.eye(4, dtype=np.float32), frames[0].hand_base,
        frames[0].hand_q, key=1, mode="init")
    assert bool(torch.isfinite(out.pose).all()) and bool(torch.isfinite(out.fitness))
