"""NaN guard of the port (counterpart of tests/test_debug_guards.py). The
reference runs its frame program under `jax_debug_nans`; here every
operator of the frame runs under a TorchDispatchMode that raises on the
first one whose floating-point output holds a NaN. Like `debug_nans` it
also sees NaNs in branches that a later `where` masks out, so padding and
invalid encodings must stay finite sentinels and every division, square
root and solve must be clamped."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from icra20_hand_object_pose_tpu.ops import icp as jicp
from icra20_hand_object_pose_tpu_torch.datasets import synthetic
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.ops import icp
from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, HandConfig, PsoConfig, TrackerConfig,
)

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=64.0, cy=48.0, width=128, height=96)


class NanGuard(TorchDispatchMode):
    """Raises on the first operator whose floating-point output holds a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"{func} produced a NaN")
        return out


def _cfg(**kw) -> EstimatorConfig:
    return EstimatorConfig(
        camera=CAM,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=32),
        scene_points=256, model_points=128, render_size=48, **kw)


@pytest.fixture(scope="module")
def grasp():
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(points_per_link=64, device="cpu")
    frame = synthetic.generate_sequence(
        mesh, hand,
        synthetic.SyntheticSequenceConfig(
            n_frames=1, camera=CAM, noise_sigma=0.001, dropout=0.05, seed=1),
        device="cpu")[0]
    return mesh, hand, frame


def test_guard_raises_on_a_nan():
    with pytest.raises(FloatingPointError), NanGuard():
        torch.zeros(2) / torch.zeros(2)


def test_frame_step_nan_free_under_guard(grasp):
    mesh, hand, f = grasp
    obj = ObjectModel(mesh, model_points=128, render_points=256, device="cpu")
    est = Estimator(obj, hand, _cfg(hand=HandConfig(config_samples=2),
                                    depth_min=0.05))
    # both programs: the global init, then tracking
    tracker = Tracker(est, seed=0)
    with NanGuard():
        out = tracker.step(f.depth, f.hand_base, f.hand_q)
        assert out.reinitialized and np.isfinite(out.pose.numpy()).all()
        out = tracker.step(f.depth, f.hand_base, f.hand_q)
    assert not out.reinitialized and np.isfinite(float(out.fitness))


def test_empty_frame_nan_free_under_guard():
    """All-invalid depth (the watchdog-trigger case) exercises every
    degenerate path: zero valid points, empty centroid, all-padding ICP."""
    obj = ObjectModel(meshio.make_test_object("box"), model_points=128,
                      render_points=256, device="cpu")
    est = Estimator(obj, None, _cfg(hand=HandConfig(enabled=False)))
    with NanGuard():
        out = est.estimate(np.zeros((CAM.height, CAM.width), np.float32),
                           synthetic.default_object_pose(), key=0)
    assert np.isfinite(out.pose.numpy()).all()


def test_library_sweep_nan_free_under_guard(grasp):
    """One init step and one tracked step of a two-object library."""
    _, hand, f = grasp
    objs = [ObjectModel(meshio.make_test_object(s), model_points=128,
                        render_points=256, seed=i, device="cpu")
            for i, s in enumerate(["box", "cylinder"])]
    sweep = LibrarySweep(objs, hand, _cfg(hand=HandConfig(config_samples=2),
                                          depth_min=0.05))
    st = sweep.init_state()
    frames = (np.stack([f.depth] * 2), np.stack([f.hand_base] * 2),
              np.stack([f.hand_q] * 2))
    with NanGuard():
        st, res = sweep.step(st, *frames)
        assert bool(res.reinitialized.all())
        st, res = sweep.step(st, *frames)
    assert np.isfinite(res.poses.numpy()).all()
    assert np.isfinite(res.fitness.numpy()).all()


def _damped_normal_equations(seed: int, planar: bool):
    """256 damped point-to-plane systems of 64 points each, built as
    `icp.solve_gn_step` builds them: (H + lam I, g, lam). `planar` gives
    every point of a system one normal, so H has rank 3 and the damped
    pivots of its null directions sit at FP32 rounding."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(256, 64, 3)) * 0.05 + np.array([0.0, 0.0, 0.6])
    n = rng.normal(size=(256, 1 if planar else 64, 3))
    n = np.broadcast_to(n / np.linalg.norm(n, axis=-1, keepdims=True), p.shape)
    r = rng.normal(size=(256, 64, 1)) * 1e-3
    p, n, r = (torch.tensor(a, dtype=torch.float32) for a in (p, n, r))
    J = torch.cat([torch.linalg.cross(p, n), n], dim=-1)
    H = J.transpose(-1, -2) @ J
    g = (J.transpose(-1, -2) @ r)[..., 0]
    lam = 1e-6 * (torch.diagonal(H, dim1=-2, dim2=-1).sum(-1) / 6.0 + 1e-12)
    return H + lam[..., None, None] * torch.eye(6), g, lam


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cholesky_pivot_floor_keeps_planar_systems_finite(seed):
    """A planar patch leaves some damped systems FP32-indefinite. The
    reference's pivot clamp (1e-20, `ops/icp.py` of the JAX package) solves
    them to inf - inf; the port's pivot floor, the damping, keeps every
    solve finite and inside the damped system's bound |x| <= |g| / lam."""
    H, g, lam = _damped_normal_equations(seed, planar=True)
    ref = np.asarray(jicp.cholesky_solve6(jnp.asarray(H.numpy()),
                                          jnp.asarray(g.numpy())))
    old = icp.cholesky_solve6(H, g, torch.full_like(lam, 1e-20))
    assert not np.isfinite(ref).all()                   # the branch is reached
    assert not torch.isfinite(old).all()
    with NanGuard():
        x = icp.cholesky_solve6(H, g, lam)
    assert torch.isfinite(x).all()
    bound = 2.0 * g.norm(dim=-1) / lam
    assert (x.norm(dim=-1) <= bound).all()
    # a system whose pivots all stay above 1e-20 solves as the reference's
    ok = torch.isfinite(old).all(-1) & (old.norm(dim=-1) <= bound)
    assert ok.float().mean() > 0.5 and torch.equal(x[ok], old[ok])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cholesky_matches_reference_when_well_conditioned(seed):
    """Normals in every direction: no pivot reaches the floor, so the port's
    solve is the reference's, and the floor argument changes nothing."""
    H, g, lam = _damped_normal_equations(seed, planar=False)
    x = icp.cholesky_solve6(H, g, lam)
    ref = np.asarray(jicp.cholesky_solve6(jnp.asarray(H.numpy()),
                                          jnp.asarray(g.numpy())))
    assert torch.equal(x, icp.cholesky_solve6(H, g, torch.full_like(lam, 1e-20)))
    np.testing.assert_allclose(x.numpy(), ref, rtol=1e-5, atol=1e-7)
