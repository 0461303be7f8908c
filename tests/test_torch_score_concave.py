"""Concave-geometry checks of the port's point-mode scorer (counterpart of
the first two tests of tests/test_score_concave.py), at the reference's
thresholds. Point mode approximates z-buffer visibility by back-face
culling; on concave shapes (L-bracket, tee, mug) a front-facing sample can
hide behind another part of the object. Against the exact-z-buffer pixel
mode and the true pose error:

  - at swarm sigma, point-vs-pixel rank correlation > 0.8, and both rank by
    true error (> 0.5 point, > 0.4 pixel);
  - with the ground truth among the candidates, point mode's argmax picks
    it, and at polish sigma its ranking follows true error (> 0.7).

The candidate poses come from the JAX package's `se3.perturb_pose` on the
reference's key; the same numpy poses and frame go through both packages'
`score_particles`, which must agree within 1e-5. The reference's third test
(`test_tracking_concave_mug`) is statistical and waits for the card."""
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
from icra20_hand_object_pose_tpu_torch.ops.pso import score_particles
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, ScoreConfig,
)

torch.set_num_threads(2)

CAM = CameraIntrinsics(fx=140.0, fy=140.0, cx=80.0, cy=60.0, width=160, height=120)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _score_setup(kind: str, P: int, rot_sigma: float, trans_sigma: float):
    """An exact-raster frame of a tilted object and P candidates around the
    ground truth (candidate 0 exact); returns (point fitness, pixel fitness,
    ADD error [P]) of the port, after holding both modes against the JAX
    package's scores of the same candidates."""
    mesh = meshio.make_test_object(kind)
    obj = ObjectModel(mesh, model_points=512, render_points=1024, device="cpu")
    # tilt so that the concavity is partly visible (cavity self-occlusion)
    tilt = np.asarray(jse3.se3_exp(
        jnp.asarray([0.9, 0.3, 0.0, 0.0, 0.0, 0.0], jnp.float32)))
    pose_gt = (synthetic.default_object_pose(0.45) @ tilt).astype(np.float32)
    depth = synthetic.render_frame(
        mesh, pose_gt, None, np.eye(4, dtype=np.float32), np.zeros(2, np.float32),
        CAM, noise_sigma=0.0, device="cpu")
    poses = np.array(jse3.perturb_pose(jax.random.key(0), jnp.asarray(pose_gt),
                                       rot_sigma, trans_sigma, shape=(P,)))
    poses[0] = pose_gt
    hand = np.full(depth.shape, np.inf, np.float32)
    kw = dict(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
              height=CAM.height, width=CAM.width, splat_radius=1)
    fits = []
    for mode in ("point", "pixel"):
        f, _ = score_particles(
            _t(poses), obj.render_pts, obj.render_normals, obj.render_w,
            _t(depth), torch.as_tensor(depth > 0), _t(hand),
            score_cfg=ScoreConfig(mode=mode), **kw)
        jf, _ = jpso.score_particles(
            jnp.asarray(poses), jnp.asarray(obj.render_pts.numpy()),
            jnp.asarray(obj.render_normals.numpy()),
            jnp.asarray(obj.render_w.numpy()), jnp.asarray(depth),
            jnp.asarray(depth > 0), jnp.asarray(hand),
            score_cfg=JScoreConfig(mode=mode), **kw)
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
        fits.append(f.numpy())
    dense, _ = mesh.sample_surface(2048, seed=5)
    a = dense @ poses[:, :3, :3].transpose(0, 2, 1) + poses[:, None, :3, 3]
    b = dense @ pose_gt[:3, :3].T + pose_gt[:3, 3]
    err = np.linalg.norm(a - b[None], axis=-1).mean(-1)
    return fits[0], fits[1], err


@pytest.mark.parametrize("kind", ["lbracket", "mug"])
def test_point_vs_pixel_rank_agreement(kind):
    """At swarm-search sigma the two scoring modes rank a particle cloud
    consistently, and both broadly rank by true pose error."""
    f_pt, f_px, err = _score_setup(kind, P=96, rot_sigma=0.08, trans_sigma=0.01)
    rho = spearmanr(f_pt, f_px).statistic
    assert rho > 0.8, f"{kind}: point-vs-pixel rank corr {rho:.3f}"
    assert spearmanr(f_pt, -err).statistic > 0.5
    assert spearmanr(f_px, -err).statistic > 0.4


@pytest.mark.parametrize("kind", ["lbracket", "tee", "mug"])
def test_point_mode_peaks_at_gt_on_concave(kind):
    """Self-occlusion must not move the fitness optimum: with the exact
    ground truth among the candidates point mode's argmax selects it, and
    at polish sigma the ordering follows true pose error closely."""
    f_pt, _, err = _score_setup(kind, P=96, rot_sigma=0.02, trans_sigma=0.0025)
    assert np.argmax(f_pt) == 0, (
        f"{kind}: best particle err {err[np.argmax(f_pt)] * 1000:.2f}mm")
    rho = spearmanr(f_pt, -err).statistic
    assert rho > 0.7, f"{kind}: fine-sigma rank-vs-error corr {rho:.3f}"
