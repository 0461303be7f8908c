"""The port's point splat (exact) and hand model (FK, sampled clouds with
the JAX package's noise injected, render-space config agreement) against
the JAX package's. FK/clouds/agreement tolerance: atol 1e-5 (float32
chains of four 4x4 products; agreement sums ~1e3 pixel terms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.ops import render as jrender
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp,
)
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.ops import render
from icra20_hand_object_pose_tpu_torch.utils import rng

torch.set_num_threads(2)

CAM = dict(fx=80.0, fy=80.0, cx=40.0, cy=30.0, height=60, width=80)
HB = hand_base_for_grasp(default_object_pose(0.45))
Q = np.array([0.45, 0.40], np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_splat_depth_exact(radius):
    g = np.random.default_rng(radius)
    pts = np.stack([g.uniform(-0.35, 0.35, 3000), g.uniform(-0.25, 0.25, 3000),
                    g.uniform(0.2, 0.9, 3000)], -1).astype(np.float32)
    pts[:50, 2] = -0.1                      # behind the camera
    pts[50:60, 0] = 5.0                     # far outside the image
    # centres on pixel half-steps: round-half-to-even must match
    pts[60:100, 0] = ((np.arange(40) + 0.5) - CAM["cx"]) / CAM["fx"] * pts[60:100, 2]
    w = (g.random(3000) > 0.1).astype(np.float32)
    ref = jrender.splat_depth(jnp.asarray(pts), jnp.asarray(w), radius=radius, **CAM)
    out = render.splat_depth(torch.tensor(pts), torch.tensor(w), radius=radius, **CAM)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    batch = np.stack([pts, pts[::-1].copy()])
    refb = jrender.splat_depth_batched(jnp.asarray(batch), jnp.asarray(w),
                                       radius=radius, **CAM)
    outb = render.splat_depth_batched(torch.tensor(batch), torch.tensor(w),
                                      radius=radius, **CAM)
    np.testing.assert_array_equal(outb.numpy(), np.asarray(refb))


@pytest.fixture(scope="module")
def hands():
    return jax_t42(points_per_link=64), make_t42_hand(points_per_link=64, device="cpu")


def test_fk_and_cloud(hands):
    jh, th = hands
    _close(th.fk(torch.tensor(Q)), jh.fk(jnp.asarray(Q)))
    _close(th.cloud(torch.tensor(HB), torch.tensor(Q)),
           jh.cloud(jnp.asarray(HB), jnp.asarray(Q)))


def test_sampled_clouds_and_agreement(hands):
    jh, th = hands
    key = jax.random.key(11)
    ref = jh.sampled_clouds(key, jnp.asarray(HB), jnp.asarray(Q), 0.12, 8)
    draws = rng.Draws(jax.random.normal(key, (8, 2)))
    out = th.sampled_clouds(draws, torch.tensor(HB), torch.tensor(Q), 0.12, 8)
    _close(out, ref)
    # observed depth: the nominal hand plus a plane behind it, some holes
    obs = np.asarray(jrender.splat_depth(ref[0], jnp.ones(ref.shape[1]),
                                         radius=2, **CAM))
    obs = np.where(np.isfinite(obs), obs, 0.6).astype(np.float32)
    obs[::7, ::5] = 0.0
    valid = obs > 0
    agree_ref = jh.config_agreement(ref, jnp.asarray(obs), jnp.asarray(valid), **CAM)
    agree = th.config_agreement(out, torch.tensor(obs), torch.tensor(valid), **CAM)
    _close(agree, agree_ref)
    assert len(set(np.round(np.asarray(agree_ref), 4))) == 8  # no ties
    np.testing.assert_array_equal(torch.topk(agree, 3).indices.numpy(),
                                  np.asarray(jax.lax.top_k(agree_ref, 3)[1]))
