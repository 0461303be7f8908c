"""The port's SE(3) math against the JAX package's on the same inputs, and
its sampling sites fed the JAX package's own draws. Tolerance: atol 1e-6
(float32 at unit scale; the two frameworks may order a 3-term sum
differently)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.utils import rng, se3

torch.set_num_threads(2)
ATOL = 1e-6


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _twists(n, seed=0, rot=1.0, trans=0.2):
    g = np.random.default_rng(seed)
    w = g.normal(size=(n, 3)) * rot
    v = g.normal(size=(n, 3)) * trans
    return np.concatenate([w, v], -1).astype(np.float32)


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("fn", ["so3_exp", "hat"])
def test_so3_maps(fn):
    w = _twists(64)[:, :3]
    w[0] = 0.0
    w[1] = 1e-5   # inside the series branch
    _close(getattr(se3, fn)(_t(w)), getattr(jse3, fn)(jnp.asarray(w)))


def test_exp_log_compose_inverse():
    xi = _twists(64, seed=1)
    T = se3.se3_exp(_t(xi))
    Tj = jse3.se3_exp(jnp.asarray(xi))
    _close(T, Tj)
    _close(se3.se3_log(T), jse3.se3_log(Tj), atol=1e-5)  # log of a rounded pose
    _close(se3.so3_log(T[:, :3, :3]), jse3.so3_log(Tj[:, :3, :3]), atol=1e-5)
    _close(se3.compose(T[:32], T[32:]), jse3.compose(Tj[:32], Tj[32:]))
    _close(se3.inverse(T), jse3.inverse(Tj))
    _close(se3.matrix_to_quat(T[:, :3, :3]), jse3.matrix_to_quat(Tj[:, :3, :3]))
    _close(se3.pose7_to_pose(se3.pose_to_pose7(T)),
           jse3.pose7_to_pose(jse3.pose_to_pose7(Tj)))


def test_transforms_and_twist_updates():
    g = np.random.default_rng(2)
    pts = (g.normal(size=(8, 50, 3)) * 0.1).astype(np.float32)
    xi = _twists(8, seed=3, rot=0.2, trans=0.02)
    T = jse3.se3_exp(jnp.asarray(_twists(8, seed=4)))
    Tt = _t(T)
    _close(se3.transform_points(Tt, _t(pts)), jse3.transform_points(T, pts))
    _close(se3.rotate_vectors(Tt, _t(pts)), jse3.rotate_vectors(T, pts))
    _close(se3.apply_twist(_t(xi), Tt), jse3.apply_twist(jnp.asarray(xi), T))
    anchor = pts[:, 0]
    _close(se3.apply_twist_about(_t(xi), Tt, _t(anchor)),
           jse3.apply_twist_about(jnp.asarray(xi), T, jnp.asarray(anchor)))


def test_perturb_pose_with_injected_draws():
    key = jax.random.key(5)
    T = jse3.se3_exp(jnp.asarray(_twists(1, seed=6)[0]))
    ref = jse3.perturb_pose(key, T, 0.12, 0.015, shape=(16,))
    kw, kv = jax.random.split(key)
    draws = rng.Draws(jax.random.normal(kw, (16, 3)), jax.random.normal(kv, (16, 3)))
    out = se3.perturb_pose(draws, _t(T), 0.12, 0.015, shape=(16,))
    assert len(draws) == 0
    _close(out, ref)


def test_super_fibonacci_with_injected_offset():
    key = jax.random.key(7)
    ref = jse3.super_fibonacci_rotations(128, key)
    out = se3.super_fibonacci_rotations(
        128, rng.Draws(jax.random.uniform(key, (3,))))
    _close(out, ref, atol=2e-6)   # sin/cos of ~1e3 rad arguments
    _close(se3.super_fibonacci_rotations(64), jse3.super_fibonacci_rotations(64),
           atol=2e-6)


def test_generator_draws_are_valid_rotations():
    gen = torch.Generator().manual_seed(0)
    R = se3.random_rotation(gen, (32,))
    _close(R @ R.transpose(-1, -2), np.broadcast_to(np.eye(3), (32, 3, 3)), atol=1e-5)
    _close(torch.linalg.det(R), np.ones(32), atol=1e-5)


def test_add_metrics():
    g = np.random.default_rng(8)
    pts = (g.normal(size=(200, 3)) * 0.05).astype(np.float32)
    Ta = jse3.se3_exp(jnp.asarray(_twists(1, seed=9, rot=0.1, trans=0.01)[0]))
    Tb = jse3.se3_exp(jnp.asarray(_twists(1, seed=10, rot=0.1, trans=0.01)[0]))
    _close(se3.add_s_error(_t(Ta), _t(Tb), _t(pts)),
           jse3.add_s_error(Ta, Tb, jnp.asarray(pts)))
    _close(se3.add_error(_t(Ta), _t(Tb), _t(pts)),
           jse3.add_error(Ta, Tb, jnp.asarray(pts)))



@pytest.mark.parametrize("fn", ["compose", "inverse", "se3_exp", "se3_log", "apply_twist"])
def test_small_products_are_batch_invariant(fn):
    """The small matrix products are elementwise sums in a fixed order, not a
    batched GEMM (on CUDA its kernel, and the rounding, follows the batch
    count): row i of a batch is bitwise the call on row i alone."""
    xi = _t(_twists(33, seed=4))
    T = se3.se3_exp(_t(_twists(33, seed=5)))
    args = {"compose": (T, se3.inverse(T)), "inverse": (T,), "se3_exp": (xi,),
            "se3_log": (T,), "apply_twist": (xi, T)}[fn]
    out = getattr(se3, fn)(*args)
    for i in (0, 17, 32):
        assert torch.equal(out[i], getattr(se3, fn)(*(a[i:i + 1] for a in args))[0])


def test_compose_sums_its_products_left_to_right():
    A = se3.se3_exp(_t(_twists(33, seed=4)))
    B = se3.se3_exp(_t(_twists(33, seed=5)))
    want = A[..., :, 0, None] * B[..., None, 0, :]
    for k in range(1, 4):
        want = want + A[..., :, k, None] * B[..., None, k, :]
    assert torch.equal(se3.compose(A, B), want)
