"""The port's depth preprocessing against the JAX package's on the same
frame, with the JAX package's own subsample draws injected. Masks and
sample indices must agree exactly; floats to atol 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import preprocess as jpre
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp, render_frame_fast,
)
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.ops import preprocess
from icra20_hand_object_pose_tpu_torch.utils import meshio, rng
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

torch.set_num_threads(2)

CAM = CameraIntrinsics(width=96, height=72, fx=86.4, fy=86.4, cx=48.0, cy=36.0)


@pytest.fixture(scope="module")
def frame():
    pose = default_object_pose()
    hb = hand_base_for_grasp(pose)
    depth = render_frame_fast(
        meshio.make_test_object("box"), pose,
        make_t42_hand(points_per_link=64, device="cpu"),
        hb, np.array([0.45, 0.45], np.float32), CAM, n_points=4096,
        noise_sigma=0.001, rng=np.random.default_rng(0),
    )
    # speckle, out-of-range and hand-dropped pixels for every mask path
    g = np.random.default_rng(1)
    depth[g.random(depth.shape) < 0.02] = 3.0
    extra = np.zeros(depth.shape, bool)
    extra[30:40, 20:35] = True
    return depth, extra


def _exact(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6, rtol=0)


@pytest.mark.parametrize("render_factor,outlier_tau", [(1, 0.0), (3, 0.02)])
def test_preprocess_frame(frame, render_factor, outlier_tau):
    depth, extra = frame
    n_points = 256
    kw = dict(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, depth_min=0.1,
              depth_max=2.0, n_points=n_points, render_factor=render_factor,
              outlier_tau=outlier_tau)
    key = jax.random.key(3)
    ref = jpre.preprocess_frame(key, jnp.asarray(depth),
                                extra_invalid=jnp.asarray(extra), **kw)
    # the JAX subsample splits its key into (priorities, permutation)
    k_pri, k_perm = jax.random.split(key)
    draws = rng.Draws(jax.random.uniform(k_pri, (depth.size,)),
                      jax.random.permutation(k_perm, n_points))
    out = preprocess.preprocess_frame(draws, torch.tensor(depth),
                                      extra_invalid=torch.tensor(extra), **kw)
    assert len(draws) == 0
    for f in ("weights", "valid", "valid_full", "neutral", "neutral_full"):
        _exact(getattr(out, f), getattr(ref, f))
    for f in ("points", "normals", "depth", "depth_full"):
        _close(getattr(out, f), getattr(ref, f))
    assert float(out.weights.sum()) > 0.5 * n_points


def test_speckle_and_pools(frame):
    depth, _ = frame
    valid = depth > 0.1
    _exact(preprocess.speckle_mask(torch.tensor(depth), torch.tensor(valid),
                                   tau=0.02, min_neighbors=2),
           jpre.speckle_mask(jnp.asarray(depth), jnp.asarray(valid), tau=0.02,
                             min_neighbors=2))
    for f in (2, 4):
        d, v = preprocess.downsample_depth(torch.tensor(depth),
                                           torch.tensor(valid), f)
        dj, vj = jpre.downsample_depth(jnp.asarray(depth), jnp.asarray(valid), f)
        _exact(d, dj)
        _exact(v, vj)
        _exact(preprocess.downsample_mask_any(torch.tensor(~valid), f),
               jpre.downsample_mask_any(jnp.asarray(~valid), f))
