"""The port's self-occlusion masking of point-mode scoring (counterpart of
tests/test_self_occlusion.py), at the reference's thresholds:

  1. rank agreement >= 0.95 between the scores under the shipped
     search-region mask and under an exact-visibility oracle (a triangle
     raster per candidate pose), with the argmax at the ground truth;
  2. an all-true mask is a bitwise no-op (fitness and coverage);
  3. a flipped candidate whose facing half the incumbent mask culls to a
     sliver stays below the true pose (ScoreConfig.self_occ_count_floor).

The candidate poses come from the JAX package's `se3.perturb_pose` on the
reference's keys; the same numpy poses, frame and masks go through both
packages' `score_particles`, which must agree within 1e-5."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import spearmanr

from icra20_hand_object_pose_tpu.ops import pso as jpso
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu.utils.config import ScoreConfig as JScoreConfig
from icra20_hand_object_pose_tpu_torch.datasets import synthetic
from icra20_hand_object_pose_tpu_torch.models import ObjectModel
from icra20_hand_object_pose_tpu_torch.ops import render
from icra20_hand_object_pose_tpu_torch.ops.pso import score_particles
from icra20_hand_object_pose_tpu_torch.utils import meshio, se3
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, ScoreConfig,
)

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0,
                       width=160, height=120)
KW = dict(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
          height=CAM.height, width=CAM.width)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _incumbent_mask(obj, pose, margin=0.008, rot_sigma=0.0, trans_sigma=0.0,
                    n_union=0):
    """The visibility test of Estimator._self_occlusion_mask, standalone, as
    the reference's test writes it: with n_union > 0 the shipped
    search-region union (the incumbent and n_union perturbed poses, drawn by
    the JAX package from key 7), else the incumbent alone."""
    poses = np.asarray(pose, np.float32)[None]
    if n_union > 0:
        region = jse3.perturb_pose(
            jax.random.key(7), jnp.tile(jnp.asarray(poses), (n_union, 1, 1)),
            rot_sigma, trans_sigma, shape=(n_union,))
        poses = np.concatenate([poses, np.asarray(region)], axis=0)
    poses = _t(poses)
    inc = se3.transform_points(poses, obj.render_pts)
    nrm = se3.rotate_vectors(poses, obj.render_normals)
    d = render.splat_depth_batched(inc, obj.render_w.expand(len(poses), -1),
                                   radius=1, **KW)
    z = inc[..., 2]
    zs = torch.where(z > 1e-6, z, 1.0)
    ui = torch.clamp(torch.round(inc[..., 0] / zs * CAM.fx + CAM.cx).long(),
                     0, CAM.width - 1)
    vi = torch.clamp(torch.round(inc[..., 1] / zs * CAM.fy + CAM.cy).long(),
                     0, CAM.height - 1)
    d_at = torch.gather(d.reshape(d.shape[0], -1), 1, vi * CAM.width + ui)
    ray = inc / torch.clamp(torch.linalg.norm(inc, dim=-1, keepdim=True), min=1e-9)
    cosv = torch.clamp(-torch.sum(nrm * ray, dim=-1), 1e-3, 1.0)
    tanv = torch.sqrt(1.0 - cosv ** 2) / cosv
    vis = torch.any(
        d_at >= z - (margin + 1.5 * (z / CAM.fx) * torch.clamp(tanv, max=4.0)),
        dim=0)
    return (vis | torch.any(tanv > 2.5, dim=0)).numpy()  # grazing exemption


def _oracle_vis(mesh, poses, render_pts):
    """[P,N] exact per-candidate visibility: a triangle raster per pose."""
    verts = _t(mesh.vertices)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64))
    outs = []
    for p in np.asarray(poses):
        pt = _t(p)
        zb = render.raster_depth(verts @ pt[:3, :3].T + pt[:3, 3], faces, **KW)
        pts = se3.transform_points(pt, render_pts)
        z = pts[..., 2]
        zs = torch.where(z > 1e-6, z, 1.0)
        ui = torch.clamp(torch.round(pts[..., 0] / zs * CAM.fx + CAM.cx).long(),
                         0, CAM.width - 1)
        vi = torch.clamp(torch.round(pts[..., 1] / zs * CAM.fy + CAM.cy).long(),
                         0, CAM.height - 1)
        outs.append((z <= zb.reshape(-1)[vi * CAM.width + ui] + 0.002).numpy())
    return np.stack(outs)


def _setup(kind, P, rot_sigma, trans_sigma):
    mesh = meshio.make_test_object(kind)
    obj = ObjectModel(mesh, model_points=512, render_points=1024, device="cpu")
    tilt = np.asarray(jse3.se3_exp(jnp.asarray([0.9, 0.3, 0, 0, 0, 0], jnp.float32)))
    pose_gt = (synthetic.default_object_pose(0.45) @ tilt).astype(np.float32)
    depth = synthetic.render_frame(
        mesh, pose_gt, None, np.eye(4, dtype=np.float32),
        np.zeros(2, np.float32), CAM, noise_sigma=0.0, device="cpu")
    poses = np.array(jse3.perturb_pose(jax.random.key(0), jnp.asarray(pose_gt),
                                       rot_sigma, trans_sigma, shape=(P,)))
    poses[0] = pose_gt
    return mesh, obj, pose_gt, poses, depth


def _score(obj, poses, depth, sample_mask=None):
    """(fitness, coverage) of the port and of the JAX package on the same
    poses, frame and mask ([Nr], or [P,Nr]: one per candidate); they must
    agree within 1e-5. The port takes a mask per candidate in its library
    form, each candidate an object of one particle."""
    hand = np.full(depth.shape, np.inf, np.float32)
    common = dict(splat_radius=1, **KW)
    args = (_t(poses), obj.render_pts, obj.render_normals, obj.render_w,
            _t(depth), torch.as_tensor(depth > 0), _t(hand))
    if sample_mask is not None and sample_mask.ndim == 2:
        P = len(poses)
        args = ((args[0][:, None],)
                + tuple(a.expand(P, *a.shape) for a in args[1:4])
                + tuple(a[None] for a in args[4:]))
    f, c = score_particles(
        *args, score_cfg=ScoreConfig(mode="point"),
        sample_mask=None if sample_mask is None else torch.as_tensor(sample_mask),
        **common)
    f, c = f.reshape(-1), c.reshape(-1)
    jf, jc = jpso.score_particles(
        jnp.asarray(poses), jnp.asarray(obj.render_pts.numpy()),
        jnp.asarray(obj.render_normals.numpy()), jnp.asarray(obj.render_w.numpy()),
        jnp.asarray(depth), jnp.asarray(depth > 0), jnp.asarray(hand),
        score_cfg=JScoreConfig(mode="point"),
        sample_mask=None if sample_mask is None else jnp.asarray(sample_mask),
        **common)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5, rtol=0)
    return f.numpy(), c.numpy()


@pytest.mark.parametrize("kind", ["lbracket", "mug"])
def test_masked_rank_vs_exact_oracle(kind):
    mesh, obj, pose_gt, poses, depth = _setup(kind, 64, 0.08, 0.01)
    # the shipped mask: the search-region union at the candidate spread
    f_m, _ = _score(obj, poses, depth, _incumbent_mask(
        obj, pose_gt, rot_sigma=0.08, trans_sigma=0.01, n_union=6))
    f_or, _ = _score(obj, poses, depth, _oracle_vis(mesh, poses, obj.render_pts))
    rho = spearmanr(f_m, f_or).statistic
    assert rho >= 0.95, f"{kind}: masked-vs-oracle rank corr {rho:.3f}"
    assert int(np.argmax(f_m)) == 0


def test_all_true_mask_is_noop():
    _, obj, _, poses, depth = _setup("tee", 48, 0.05, 0.008)
    f0, c0 = _score(obj, poses, depth)
    f1, c1 = _score(obj, poses, depth, np.ones(obj.render_pts.shape[0], bool))
    np.testing.assert_array_equal(f0, f1)
    np.testing.assert_array_equal(c0, c1)


def test_sliver_candidate_cannot_win():
    """A flipped candidate whose visible half the incumbent mask culls must
    stay below the true pose even if its surviving sliver matches: the
    denominator floor scales its fitness by the unmasked count."""
    _, obj, pose_gt, poses, depth = _setup("tee", 8, 0.01, 0.001)
    # candidate 7: a 180-degree flip about the camera-vertical axis
    flip = np.asarray(jse3.se3_exp(jnp.asarray([0.0, np.pi, 0, 0, 0, 0], jnp.float32)))
    poses[7] = (pose_gt @ flip).astype(np.float32)
    f, _ = _score(obj, poses, depth, _incumbent_mask(obj, pose_gt))
    assert np.argmax(f) == 0, f
    assert f[7] < f[0], f
