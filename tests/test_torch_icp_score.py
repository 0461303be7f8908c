"""The port's batched ICP, scene support and point-mode scorer against the
JAX package's on the same inputs.

ICP runs the corr_fn path on both sides (the port's plain K1, the JAX
package's Pallas K1 in interpret mode) and the dense default path; poses
must agree within 1e-5 after 3 iterations of 3 GN re-linearizations.
Scoring covers both gather rules ("take" and "mxu", image and per-sample
patch form) at both tiers (nearest and sub-pixel); fitness and coverage
within 1e-5. The observed and hand depths are quantized to 2^-14 m so that
the TPU path's double-bf16 lookup tables hold them exactly, which makes the
"mxu" comparison one of rules rather than of rounding."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import gather_mxu, knn_pallas
from icra20_hand_object_pose_tpu.ops import icp as jicp
from icra20_hand_object_pose_tpu.ops import score as jscore
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp, render_frame_fast,
)
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.ops import icp, knn_cuda, render, score
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

torch.set_num_threads(2)

BOX = meshio.make_test_object("box")
T_GT = default_object_pose(0.45)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _poses(n, seed, rot, trans):
    """n perturbations of T_GT from numpy-drawn twists (pose 0 = T_GT)."""
    g = np.random.default_rng(seed)
    xi = np.concatenate([g.normal(size=(n, 3)) * rot,
                         g.normal(size=(n, 3)) * trans], -1).astype(np.float32)
    xi[0] = 0.0
    return np.asarray(jse3.apply_twist_about(
        jnp.asarray(xi), jnp.broadcast_to(jnp.asarray(T_GT), (n, 4, 4)),
        jnp.broadcast_to(jnp.asarray(T_GT[:3, 3]), (n, 3))))


@pytest.fixture(scope="module")
def icp_inputs():
    mpts, mnrm = BOX.sample_surface(160, seed=0)
    spts, snrm = BOX.sample_surface(120, seed=1)
    g = np.random.default_rng(2)
    scene = spts @ T_GT[:3, :3].T + T_GT[:3, 3] + g.normal(size=spts.shape) * 5e-4
    scene_n = snrm @ T_GT[:3, :3].T
    w = np.ones(len(scene), np.float32)
    w[::9] = 0.0                          # padding-style slots
    scene[::9] = 1e6
    scene_n[::11] = 0.0                   # missing normals
    return (scene.astype(np.float32), scene_n.astype(np.float32), w,
            mpts, mnrm, _poses(6, 3, 0.05, 0.006))


@pytest.mark.parametrize("path", ["corr_fn", "dense"])
def test_icp_batched(icp_inputs, path):
    scene, scene_n, w, mpts, mnrm, poses0 = icp_inputs
    kw = dict(iters=3, max_corresp_dist=0.02, gn_reps=3, support_tau=0.012)
    ref, ref_st = jicp.icp_batched(
        *map(jnp.asarray, (poses0, scene, scene_n, w, mpts, mnrm)),
        corr_fn=(knn_pallas.make_corr_fn(tile_s=128, tile_m=128, interpret=True)
                 if path == "corr_fn" else None), **kw)
    out, st = icp.icp_batched(
        *map(_t, (poses0, scene, scene_n, w, mpts, mnrm)),
        corr_fn=knn_cuda.make_corr_fn() if path == "corr_fn" else None, **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(st.support.numpy(), np.asarray(ref_st.support),
                               atol=1e-6)
    np.testing.assert_allclose(st.inliers.numpy(), np.asarray(ref_st.inliers),
                               atol=1e-6)
    np.testing.assert_allclose(st.rmse.numpy(), np.asarray(ref_st.rmse),
                               atol=1e-6)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(ref_st.converged))


def test_scene_support(icp_inputs):
    scene, _, w, mpts, mnrm, _ = icp_inputs
    poses = _poses(8, 4, 0.1, 0.01)
    ref = jicp.scene_support(
        *map(jnp.asarray, (poses, scene, w, mpts, mnrm)), tau=0.012,
        corr_fn=knn_pallas.make_corr_fn(tile_s=128, tile_m=128, interpret=True))
    out = icp.scene_support(*map(_t, (poses, scene, w, mpts, mnrm)), tau=0.012,
                            corr_fn=knn_cuda.make_corr_fn())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)


def test_icp_single_is_row_zero_of_batched(icp_inputs):
    scene, scene_n, w, mpts, mnrm, poses0 = icp_inputs
    kw = dict(iters=3, max_corresp_dist=0.02, gn_reps=3, support_tau=0.012)
    args = tuple(map(_t, (scene, scene_n, w, mpts, mnrm)))
    for row in (0, 4):
        batched, bst = icp.icp_batched(_t(poses0[row:row + 1]), *args, **kw)
        pose, st = icp.icp(_t(poses0[row]), *args, **kw)
        assert pose.shape == (4, 4) and st.rmse.shape == ()
        assert torch.equal(pose, batched[0])
        for a, b in zip(st, bst):
            assert torch.equal(a, b[0])
    ref, ref_st = jicp.icp(jnp.asarray(poses0[4]),
                           *map(jnp.asarray, (scene, scene_n, w, mpts, mnrm)), **kw)
    np.testing.assert_allclose(pose.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(st.rmse), float(ref_st.rmse), atol=1e-6)


CAM = CameraIntrinsics(width=80, height=60, fx=80.0, fy=80.0, cx=40.0, cy=30.0)
PATCH = 16


@pytest.fixture(scope="module")
def frame():
    hand = make_t42_hand(points_per_link=64, device="cpu")
    hb = hand_base_for_grasp(T_GT)
    q = np.array([0.45, 0.45], np.float32)
    depth = render_frame_fast(BOX, T_GT, hand, hb, q, CAM, n_points=4096,
                              noise_sigma=0.001, rng=np.random.default_rng(0),
                              device="cpu")
    quant = 2.0 ** -14
    depth = np.round(depth / quant) * quant
    depth[20:24, 10:60] = 0.0                     # a no-return band
    valid = depth > 0.1
    neutral = np.zeros_like(valid)
    neutral[36:44, 30:40] = True
    valid &= ~neutral
    depth = np.where(valid, depth, 0.0).astype(np.float32)
    hd = render.splat_depth(hand.cloud(_t(hb), _t(q)), torch.ones(5 * 64),
                            fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy,
                            height=CAM.height, width=CAM.width, radius=1).numpy()
    hd = np.where(np.isfinite(hd), np.round(hd / quant) * quant, np.inf)
    rpts, rnrm = BOX.sample_surface(400, seed=1)
    poses = _poses(12, 5, 0.08, 0.01)
    pts = np.einsum("pij,nj->pni", poses[:, :3, :3], rpts) + poses[:, None, :3, 3]
    nrm = np.einsum("pij,nj->pni", poses[:, :3, :3], rnrm)
    mask = np.random.default_rng(6).random(400) > 0.2
    return (depth, valid, neutral, hd.astype(np.float32), pts.astype(np.float32),
            nrm.astype(np.float32), mask)


def _jax_tables(form, enc, hd, pts0):
    sent = jnp.where(jnp.isfinite(hd), hd, jscore._FAR)
    if form == "image":
        return ("image", *gather_mxu.split_bf16(enc), *gather_mxu.split_bf16(sent))
    pv0, pu0 = _patch_origins(pts0)
    pv0, pu0 = jnp.asarray(pv0), jnp.asarray(pu0)
    return ("patch",
            *gather_mxu.split_bf16(gather_mxu.extract_patches(enc, pv0, pu0, PATCH)),
            *gather_mxu.split_bf16(gather_mxu.extract_patches(sent, pv0, pu0, PATCH)),
            pv0, pu0)


def _patch_origins(pts0):
    z = np.maximum(pts0[:, 2], 1e-6)
    u = np.round(pts0[:, 0] / z * CAM.fx + CAM.cx).astype(np.int32)
    v = np.round(pts0[:, 1] / z * CAM.fy + CAM.cy).astype(np.int32)
    return (np.clip(v - PATCH // 2, 0, CAM.height - PATCH),
            np.clip(u - PATCH // 2, 0, CAM.width - PATCH))


@pytest.mark.parametrize("gather,subpixel,masked", [
    ("take", False, False), ("take", True, True),
    ("image", False, True), ("image", True, False),
    ("patch", False, False), ("patch", True, True),
])
def test_compare_points(frame, gather, subpixel, masked):
    depth, valid, neutral, hd, pts, nrm, mask = frame
    kw = dict(fx=CAM.fx, fy=CAM.fy, cx=CAM.cx, cy=CAM.cy, height=CAM.height,
              width=CAM.width, depth_tau=0.01, subpixel=subpixel,
              neutral_cov_exempt=masked)
    enc_j = jscore.encode_observed(jnp.asarray(depth), jnp.asarray(valid), 1,
                                   neutral=jnp.asarray(neutral))
    enc = score.encode_observed(_t(depth), torch.tensor(valid), 1,
                                neutral=torch.tensor(neutral))
    np.testing.assert_array_equal(enc.numpy(), np.asarray(enc_j))
    if gather == "take":
        tab_j = tab = None
    else:
        tab_j = _jax_tables(gather, enc_j, jnp.asarray(hd), pts[0])
        tab = (("image", enc, score.hand_table(_t(hd))) if gather == "image" else
               ("patch", enc, score.hand_table(_t(hd)),
                *map(torch.tensor, _patch_origins(pts[0])), PATCH))
    ref = jscore.compare_points(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(depth), jnp.asarray(valid),
        jnp.asarray(hd), observed_enc=enc_j, mxu_tables=tab_j,
        sample_mask=jnp.asarray(mask) if masked else None, **kw)
    out = score.compare_points(
        _t(pts), _t(nrm), _t(depth), torch.tensor(valid), _t(hd),
        observed_enc=enc, mxu_tables=tab,
        sample_mask=torch.tensor(mask) if masked else None, **kw)
    for f in ("fitness", "coverage"):
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)), atol=1e-5)
    np.testing.assert_allclose(out.counted.numpy(), np.asarray(ref.counted))
    assert float(out.counted.min()) >= 10      # the poses see the object


def test_pack_quad_and_bilinear(frame):
    depth, valid, neutral, *_ = frame
    enc_j = jscore.encode_observed(jnp.asarray(depth), jnp.asarray(valid), 1,
                                   neutral=jnp.asarray(neutral))
    enc = score.encode_observed(_t(depth), torch.tensor(valid), 1,
                                neutral=torch.tensor(neutral))
    np.testing.assert_array_equal(score.pack_quad(enc).numpy(),
                                  np.asarray(jscore.pack_quad(enc_j)))
    g = np.random.default_rng(7)
    u = g.uniform(-0.5, CAM.width - 0.5, 500).astype(np.float32)
    v = g.uniform(-0.5, CAM.height - 0.5, 500).astype(np.float32)
    inb = np.ones(500, bool)
    ref = jscore._bilinear_depth(jnp.asarray(u), jnp.asarray(v), jnp.asarray(inb),
                                 enc_j, height=CAM.height, width=CAM.width,
                                 edge_tau=0.03)
    out = score._bilinear_depth(_t(u), _t(v), torch.tensor(inb), enc,
                                height=CAM.height, width=CAM.width, edge_tau=0.03)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
