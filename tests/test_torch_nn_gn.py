"""Kernels K2 (NN only) and K3 (NN + gates + normal equations) of the port,
through their plain versions on the CPU, against the JAX package's Pallas
kernels in interpret mode, and the ICP paths they feed (`nn_fn`, `gn_fn`).

Tolerances are the reference's own (tests/test_knn_pallas.py): NN d2 rtol
1e-3 / atol 1e-7 with equal indices; K3's H and g rtol 1e-4 / atol 1e-6,
wsum and hits rtol 1e-5, wrr rtol 1e-4 / atol 1e-8. ICP poses within 1e-5
after the same iterations (the reference's K3 reads matched points through
a double-bf16 split, ~1e-7 m here).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import icp as jicp
from icra20_hand_object_pose_tpu.ops import knn_pallas
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio
from icra20_hand_object_pose_tpu.utils import se3 as jse3
from icra20_hand_object_pose_tpu_torch.ops import icp, knn_cuda

torch.set_num_threads(2)
MIN_COS = math.cos(math.radians(60.0))


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _clouds(Pq, P, Ns, Nm, seed):
    g = np.random.default_rng(seed)
    return (g.uniform(-0.3, 0.3, (Pq, Ns, 3)).astype(np.float32),
            g.uniform(-0.3, 0.3, (P, Nm, 3)).astype(np.float32))


@pytest.mark.parametrize("Pq,P,Ns,Nm", [(1, 1, 64, 128), (2, 2, 100, 200),
                                        (1, 3, 50, 80), (3, 3, 37, 73)])
def test_nn_plain_matches_pallas(Pq, P, Ns, Nm):
    q, r = _clouds(Pq, P, Ns, Nm, seed=Ns)
    ref_idx, ref_d2 = knn_pallas.nn_batched(jnp.asarray(q), jnp.asarray(r),
                                            tile_s=64, tile_m=128, interpret=True)
    idx, d2 = knn_cuda.nn_batched(_t(q), _t(r))
    assert idx.dtype == torch.int32 and idx.shape == (P, Ns)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-3, atol=1e-7)
    # the kernel's plain version is K1's search without the gather
    _, _, d2_k1, idx_k1 = knn_cuda.nn_gather_plain(_t(q), _t(r), _t(r))
    assert torch.equal(idx, idx_k1) and torch.equal(d2, d2_k1)


def test_make_nn_fn_forms_match_pallas():
    q, r = _clouds(1, 3, 40, 70, seed=5)
    jfn = knn_pallas.make_nn_fn(tile_s=64, tile_m=64, interpret=True)
    fn = knn_cuda.make_nn_fn()
    for qq, rr in ((q[0], r[0]), (q[0], r), (np.repeat(q, 3, 0), r)):
        ref_idx, ref_d2 = jfn(jnp.asarray(qq), jnp.asarray(rr))
        idx, d2 = fn(_t(qq), _t(rr))
        assert idx.shape == tuple(ref_idx.shape)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2),
                                   rtol=1e-3, atol=1e-7)


def _gn_case():
    """tests/test_knn_pallas.py::test_gn_kernel_matches_xla_build's inputs."""
    kq, kr, kn, ksn, kw = jax.random.split(jax.random.key(7), 5)
    P, Ns, Nm = 3, 90, 130
    scene_c = jax.random.uniform(kq, (Ns, 3), minval=-0.2, maxval=0.2)
    scene_n = jax.random.normal(ksn, (Ns, 3))
    scene_n = scene_n / jnp.linalg.norm(scene_n, axis=-1, keepdims=True)
    scene_n = scene_n.at[::7].set(0.0)
    scene_w = (jax.random.uniform(kw, (Ns,)) > 0.2).astype(jnp.float32)
    ref_c = jax.random.uniform(kr, (P, Nm, 3), minval=-0.2, maxval=0.2)
    ref_n = jax.random.normal(kn, (P, Nm, 3))
    ref_n = ref_n / jnp.linalg.norm(ref_n, axis=-1, keepdims=True)
    return scene_c, scene_n, scene_w, ref_c, ref_n


def test_gn_plain_matches_pallas():
    args = _gn_case()
    gates = dict(maxd2=0.05 ** 2, min_cos=MIN_COS, tau2=0.03 ** 2)
    ref = knn_pallas.nn_gn_batched(*args, **gates, tile_s=64, tile_m=64,
                                   interpret=True)
    fn = knn_cuda.make_gn_fn(**gates)
    assert (fn.maxd2, fn.min_cos, fn.tau2) == (gates["maxd2"], MIN_COS, gates["tau2"])
    out = fn(*map(_t, args))
    (H, g, wsum, hits, wrr), (Hr, gr, wsumr, hitsr, wrrr) = out, map(np.asarray, ref)
    np.testing.assert_allclose(H.numpy(), Hr, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), gr, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wsum.numpy(), wsumr, rtol=1e-5)
    np.testing.assert_allclose(hits.numpy(), hitsr, rtol=1e-5)
    np.testing.assert_allclose(wrr.numpy(), wrrr, rtol=1e-4, atol=1e-8)
    assert float(wsum.min()) > 6.0          # the case gates in real matches


def _icp_case():
    """tests/test_knn_pallas.py's well-conditioned ICP case."""
    mesh = jmeshio.make_test_object("box")
    mpts, mnrm = mesh.sample_surface(128, seed=0)
    mpts, mnrm = jnp.asarray(mpts), jnp.asarray(mnrm)
    T_gt = jse3.make_pose(jnp.eye(3), jnp.asarray([0.0, 0.0, 0.4]))
    scene = jse3.transform_points(T_gt, mpts)
    snrm = jse3.rotate_vectors(T_gt, mnrm)
    w = jnp.ones(scene.shape[0])
    keys = jax.random.split(jax.random.key(6), 4)
    poses0 = jax.vmap(lambda k: jse3.perturb_pose(k, T_gt, 0.05, 0.008))(keys)
    return (poses0, scene, snrm, w, mpts, mnrm), T_gt


def _assert_icp_close(out, st, ref, ref_st):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
    for f in ("support", "inliers", "rmse"):
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.asarray(getattr(ref_st, f)), atol=1e-5)
    np.testing.assert_array_equal(st.converged.numpy(), np.asarray(ref_st.converged))


def test_icp_with_nn_fn_matches_reference():
    args, T_gt = _icp_case()
    kw = dict(iters=10, max_corresp_dist=0.05, gn_reps=3, support_tau=0.03)
    ref, ref_st = jicp.icp_batched(
        *args, nn_fn=knn_pallas.make_nn_fn(tile_s=64, tile_m=64, interpret=True),
        **kw)
    out, st = icp.icp_batched(*map(_t, args), nn_fn=knn_cuda.make_nn_fn(), **kw)
    _assert_icp_close(out, st, ref, ref_st)
    sup_ref = jicp.scene_support(
        ref, args[1], args[3], args[4], args[5], tau=0.03,
        nn_fn=knn_pallas.make_nn_fn(tile_s=64, tile_m=64, interpret=True))
    sup = icp.scene_support(_t(ref), *map(_t, (args[1], args[3], args[4], args[5])),
                            tau=0.03, nn_fn=knn_cuda.make_nn_fn())
    np.testing.assert_allclose(sup.numpy(), np.asarray(sup_ref), atol=1e-6)


def test_icp_with_gn_fn_matches_reference():
    args, T_gt = _icp_case()
    gates = dict(maxd2=0.05 ** 2, min_cos=MIN_COS, tau2=0.03 ** 2)
    kw = dict(iters=10, max_corresp_dist=0.05, support_tau=0.03)
    ref, ref_st = jicp.icp_batched(
        *args, gn_fn=knn_pallas.make_gn_fn(**gates, tile_s=128, tile_m=128,
                                           interpret=True), **kw)
    out, st = icp.icp_batched(*map(_t, args), gn_fn=knn_cuda.make_gn_fn(**gates),
                              **kw)
    _assert_icp_close(out, st, ref, ref_st)
    errs = [float(jse3.add_error(jnp.asarray(T), T_gt, args[4])) for T in out.numpy()]
    assert max(errs) < 0.002 and float(st.support.min()) > 0.9


def test_icp_gn_fn_guards():
    args, _ = _icp_case()
    targs = list(map(_t, args))
    fn = knn_cuda.make_gn_fn(maxd2=0.05 ** 2, min_cos=MIN_COS, tau2=0.03 ** 2)
    with pytest.raises(ValueError, match="gn_reps"):
        icp.icp_batched(*targs, iters=1, max_corresp_dist=0.05, support_tau=0.03,
                        gn_reps=3, gn_fn=fn)
    with pytest.raises(ValueError, match="maxd2"):
        icp.icp_batched(*targs, iters=1, max_corresp_dist=0.02, support_tau=0.03,
                        gn_fn=fn)
    with pytest.raises(ValueError, match="tau2"):
        icp.icp_batched(*targs, iters=1, max_corresp_dist=0.05, support_tau=0.0,
                        gn_fn=fn)


def test_gn_fn_freezes_particles_without_inliers():
    """A particle whose posed model lies far from the scene gates every match
    out (wsum_w <= 6): it must not move, and must stay finite."""
    args, _ = _icp_case()
    poses0 = np.array(args[0])
    poses0[1, 2, 3] += 1.0                       # 1 m away
    targs = [_t(poses0)] + list(map(_t, args[1:]))
    fn = knn_cuda.make_gn_fn(maxd2=0.05 ** 2, min_cos=MIN_COS, tau2=0.03 ** 2)
    out, st = icp.icp_batched(*targs, iters=3, max_corresp_dist=0.05,
                              support_tau=0.03, gn_fn=fn)
    assert torch.isfinite(out).all() and torch.isfinite(st.rmse).all()
    np.testing.assert_array_equal(out[1].numpy(), poses0[1])
    assert float(st.inliers[1]) == 0.0 and float(st.support[1]) == 0.0
