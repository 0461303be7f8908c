"""The port against the behaviour claims of `tests/test_icp.py` that no other
port test states, at the reference's sizes and thresholds:

- `test_gn_step_zero_inliers_freezes`: a damped GN step with no inlier
  weight is exactly zero (the freeze), not the pure-damping solve;
- `test_icp_converges_from_perturbation`: 30 iterations of point-to-plane
  ICP recover a perturbed pose on the reference's synthetic ellipsoid to
  under 0.5 mm ADD-S with an RMSE under 2 mm.

The problem is the reference test's own (`test_icp._make_problem`, its
numpy clouds and ground truth), and the perturbed start is the JAX
package's `perturb_pose` on the reference's key, handed to the port as an
array. Both are deterministic, so they are held exactly as the reference
holds them.
"""
import jax
import numpy as np
import torch

from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.ops import icp
from icra20_hand_object_pose_tpu_torch.utils import se3

import test_icp as ref

torch.set_num_threads(2)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def test_gn_step_zero_inliers_freezes():
    z = torch.zeros((50, 3))
    xi, _ = icp.solve_gn_step(z, z, z, torch.zeros(50), damping=1e-6)
    np.testing.assert_array_equal(xi.numpy(), 0.0)


def test_icp_converges_from_perturbation():
    """Config 1: 30-iter ICP recovers a perturbed pose on a synthetic frame.
    Error must fall well below 1mm ADD-S (BASELINE.md target)."""
    mp, mn, sp, sn, T_gt = (_t(a) for a in ref._make_problem())
    T0 = _t(jse3.perturb_pose(jax.random.key(0), np.asarray(T_gt), 0.15, 0.02))
    w = torch.ones(sp.shape[0])
    T, stats = icp.icp(T0, sp, sn, w, mp, mn, iters=30, max_corresp_dist=0.05,
                       damping=1e-6)
    err = float(se3.add_s_error(T, T_gt, mp))
    assert err < 5e-4, err  # < 0.5 mm
    assert float(stats.rmse) < 2e-3
