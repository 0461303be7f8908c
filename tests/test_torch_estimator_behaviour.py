"""The port's Estimator and Tracker against the behaviour claims of
`tests/test_estimator.py` that no other port test states, at the
reference's sizes (160 x 120, 24 particles, `test_estimator.small_config`),
configurations and thresholds:

- `test_watchdog_coverage_reinit`: a confident lock whose coverage
  collapsed (fitness 0.99, coverage 0.007, injected) re-initialises on the
  next step, and the healthy coverage after it does not;
- `test_estimate_input_validation`: the reference's `ValueError`s for a
  depth of the wrong shape, a prior that is not [4,4] and joint values of
  the wrong length;
- `test_explorer_particles_recapture_wrong_basin`: tracked mode from a
  prior 120 degrees and 6 cm off recaptures the true pose (< 10 mm) through
  the explorer particles;
- `test_fast_motion_tracking`: 12 degrees + 2 cm a frame stays tracked
  without a re-init (last frame < 2 mm, every frame < 6 mm).

The frames are the reference's own (the JAX package's `generate_sequence`
on the CPU with the reference's sequence seeds), and so are its object and
hand models (their arrays, `convert`); the wrong-basin prior is the JAX
package's `apply_twist_about` of the reference's twist. The estimator's
stream is the port's, seeded with the reference's key integers.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.datasets import synthetic
from icra20_hand_object_pose_tpu.models import ObjectModel as JaxObjectModel
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.utils import meshio
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.evaluation import add_s_error
from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
from icra20_hand_object_pose_tpu_torch.utils.config import (
    EstimatorConfig, HandConfig, IcpConfig, PsoConfig, TrackerConfig,
)

import test_estimator as ref
from torch_ref_models import port_hand, port_object

torch.set_num_threads(2)
CAM = ref.CAM


def small_config(**over):
    """test_estimator.small_config with the port's config classes."""
    base = dict(
        camera=CAM,
        icp=IcpConfig(iters=10, max_corresp_dist=0.05),
        pso=PsoConfig(particles=24, iters=4, rot_sigma=0.10, trans_sigma=0.012,
                      icp_every=1, icp_iters_inner=4, elite_frac=0.25),
        hand=HandConfig(config_samples=4),
        tracker=TrackerConfig(reinit_particles=64),
        scene_points=768,
        model_points=256,
        render_size=60,
        depth_min=0.05,
        depth_max=2.0,
    )
    base.update(over)
    return EstimatorConfig(**base)


def _model(shape: str):
    """(port ObjectModel, dense ADD-S cloud) of the reference's
    ObjectModel(mesh, model_points=256, render_points=512)."""
    jobj = JaxObjectModel(meshio.make_test_object(shape), model_points=256,
                          render_points=512)
    return port_object(jobj), np.asarray(jobj.model_pts)


@pytest.fixture(scope="module")
def setup():
    """The reference module fixture: the box, the T42 hand, 3 frames of
    sequence seed 3."""
    jhand = jax_t42(points_per_link=128)
    obj, _ = _model("box")
    scfg = synthetic.SyntheticSequenceConfig(
        n_frames=3, camera=CAM, noise_sigma=0.0008, dropout=0.01, seed=3,
        step_rot_deg=2.0, step_trans=0.003,
    )
    frames = synthetic.generate_sequence(meshio.make_test_object("box"), jhand, scfg)
    return dict(obj=obj, jhand=jhand, hand=port_hand(jhand), cfg=small_config(),
                frames=frames)


def test_watchdog_coverage_reinit(setup):
    """A drifted-but-confident lock must re-init within one frame: inject
    high fitness with collapsed coverage and the NEXT step runs global
    re-registration; the healthy coverage after it must not."""
    est = Estimator(setup["obj"], setup["hand"], setup["cfg"])
    tracker = Tracker(est, seed=0)
    f = setup["frames"][0]
    tracker.step(f.depth, f.hand_base, f.hand_q)
    tracker.state = tracker.state._replace(fitness=0.99, coverage=0.007)
    out = tracker.step(f.depth, f.hand_base, f.hand_q)
    assert out.reinitialized
    assert float(tracker.state.coverage) > est.cfg.tracker.coverage_reinit_threshold
    out2 = tracker.step(f.depth, f.hand_base, f.hand_q)
    assert not out2.reinitialized


def test_estimate_input_validation(setup):
    est = Estimator(setup["obj"], setup["hand"], setup["cfg"])
    cam = est.cfg.camera
    bad_depth = np.zeros((cam.height + 2, cam.width), np.float32)
    with pytest.raises(ValueError, match="depth shape"):
        est.estimate(bad_depth, np.eye(4))
    good_depth = np.zeros((cam.height, cam.width), np.float32)
    with pytest.raises(ValueError, match="prev_pose"):
        est.estimate(good_depth, np.eye(3))
    with pytest.raises(ValueError, match="hand_q"):
        est.estimate(good_depth, np.eye(4), np.eye(4), np.zeros((5,)))


def test_explorer_particles_recapture_wrong_basin(setup):
    """Tracked-mode recovery without the watchdog: prev_pose far from the
    truth (wrong basin), explorer particles re-seeded from the global
    distribution must recapture the true pose within one frame."""
    cfg = small_config(
        pso=dataclasses.replace(
            small_config().pso, particles=64, iters=6, explore_frac=0.25
        ),
    )
    obj, model_pts = _model("ellipsoid")
    scfg = synthetic.SyntheticSequenceConfig(
        n_frames=1, camera=CAM, noise_sigma=0.0005, dropout=0.01, seed=5,
        step_rot_deg=0.0, step_trans=0.0,
    )
    f = synthetic.generate_sequence(meshio.make_test_object("ellipsoid"),
                                    setup["jhand"], scfg)[0]
    est = Estimator(obj, setup["hand"], cfg)
    T_gt = jnp.asarray(f.pose_gt)
    # a decisively wrong prior: 120 deg about the object's own center,
    # 6 cm away (anchored twist keeps the prior in the workspace)
    wrong = np.array(jse3.apply_twist_about(
        jnp.asarray([2.1, 0.0, 0.0, 0.04, -0.03, 0.03], jnp.float32), T_gt,
        jse3.translation(T_gt),
    ))
    out = est.estimate(f.depth, wrong, f.hand_base, f.hand_q, key=4, mode="track")
    adds = add_s_error(out.pose.numpy(), f.pose_gt, model_pts)
    assert adds < 0.010, f"stuck in wrong basin: ADD-S {adds*1000:.1f}mm"


def test_fast_motion_tracking(setup):
    """Fast inter-frame motion (12 deg + 2 cm per frame, 6x/7x the swarm
    sigmas) stays tracked without reinit, on the asym object."""
    obj, model_pts = _model("asym")
    scfg = synthetic.SyntheticSequenceConfig(
        n_frames=5, camera=CAM, noise_sigma=0.0008, dropout=0.01, seed=3,
        step_rot_deg=12.0, step_trans=0.02,
    )
    frames = synthetic.generate_sequence(meshio.make_test_object("asym"),
                                         setup["jhand"], scfg)
    est = Estimator(obj, setup["hand"], setup["cfg"])
    tracker = Tracker(est, seed=0)
    tracker.state = tracker.state._replace(
        pose=est._tensor(frames[0].pose_gt), initialized=True, fitness=1.0)
    errs = []
    for f in frames[1:]:
        out = tracker.step(f.depth, f.hand_base, f.hand_q)
        assert not bool(out.reinitialized)
        errs.append(add_s_error(out.pose.numpy(), f.pose_gt, model_pts) * 1000)
    assert errs[-1] < 2.0 and max(errs) < 6.0, errs
