"""The grouped form of kernels K1, K2 and K3: a query (scene) per group of
particles, as a library sweep hands it to them (O objects, P/O particles
each, one launch). On the CPU the wrappers run their plain versions, which
are held here

- against `jax.vmap` over the object axis of the JAX package's Pallas
  kernels in interpret mode, at the reference's own tolerances
  (tests/test_knn_pallas.py): equal indices, d2 rtol 1e-3 / atol 1e-7,
  matched points atol 5e-6, normals atol 5e-4, K3's H and g rtol 1e-4 /
  atol 1e-6, wsum and hits rtol 1e-5, wrr rtol 1e-4 / atol 1e-8;
- against a loop of ungrouped calls, one per object: bitwise;
- and through the drop-ins (`make_corr_fn`, `make_nn_fn`, `make_gn_fn`) in
  the library form that ops/icp.py hands them ([O,P,4,4] poses with
  [O,Nm,3] model clouds for K1, [O,P,Nm,3] posed clouds for K2 and K3).

K1 takes the poses and the model clouds and poses them itself; the Pallas
kernels take the clouds posed by `se3.transform_points` / `rotate_vectors`.

Inputs come from numpy with a seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import knn_pallas
from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
from icra20_hand_object_pose_tpu_torch.utils import se3

torch.set_num_threads(2)
MIN_COS = math.cos(math.radians(60.0))
GATES = dict(maxd2=0.05 ** 2, min_cos=MIN_COS, tau2=0.03 ** 2)
# (objects, particles per object, Ns, Nm)
SHAPES = [(3, 4, 37, 73), (2, 1, 64, 128), (4, 2, 50, 80)]


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _unit(g, shape):
    n = g.normal(size=shape).astype(np.float32)
    return n / np.linalg.norm(n, axis=-1, keepdims=True)


def _clouds(O, Pp, Ns, Nm, seed, ties=False):
    """Queries [O,Ns,3], reference clouds and normals [O,Pp,Nm,3]; with
    `ties` the second half of every reference cloud repeats the first."""
    g = np.random.default_rng(seed)
    q = g.uniform(-0.2, 0.2, (O, Ns, 3)).astype(np.float32)
    r = g.uniform(-0.2, 0.2, (O, Pp, Nm, 3)).astype(np.float32)
    if ties:
        h = Nm // 2
        r[:, :, h:2 * h] = r[:, :, :h]
    return q, r, _unit(g, (O, Pp, Nm, 3))


def _library(O, Pp, Ns, Nm, seed, ties=False):
    """K1's library inputs: queries [O,Ns,3], poses [O,Pp,4,4], model
    clouds and normals [O,Nm,3] (with `ties` the second half of every cloud
    repeats the first), and the clouds and normals posed by se3
    [O,Pp,Nm,3]."""
    q, r, n = map(_t, _clouds(O, 1, Ns, Nm, seed, ties=ties))
    g = np.random.default_rng(seed + 1)
    w = _t(g.normal(scale=0.6, size=(O, Pp, 3)))
    poses = se3.make_pose(se3.so3_exp(w), _t(g.uniform(-0.1, 0.1, (O, Pp, 3))))
    m, mn = r[:, 0], n[:, 0]
    return (q, poses, m, mn, se3.transform_points(poses, m[:, None]),
            se3.rotate_vectors(poses, mn[:, None]))


def _scene(O, Ns, seed):
    """K3's per-object scenes: points, normals (every 7th missing) and
    weights (a fifth padding); the last object nearly empty."""
    g = np.random.default_rng(seed)
    sn = _unit(g, (O, Ns, 3))
    sn[:, ::7] = 0.0
    w = (g.random((O, Ns)) > 0.2).astype(np.float32)
    w[-1, 4:] = 0.0
    return sn, w


@pytest.mark.parametrize("O,Pp,Ns,Nm", SHAPES)
def test_grouped_nn_gather_matches_vmapped_pallas(O, Pp, Ns, Nm):
    q, poses, model, model_n, r, n = _library(O, Pp, Ns, Nm, seed=Ns)
    ref = jax.vmap(lambda qq, rr, nn: knn_pallas.nn_gather_batched(
        qq[None], rr, nn, tile_s=64, tile_m=64, interpret=True))(
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(n))
    rm, rn, rd2, ridx = (np.asarray(a).reshape((O * Pp,) + a.shape[2:]) for a in ref)
    m, nm, d2, idx = (t.reshape((O * Pp,) + t.shape[2:])
                      for t in knn_cuda.nn_gather_batched(q, poses, model, model_n))
    assert idx.dtype == torch.int32 and idx.shape == (O * Pp, Ns)
    np.testing.assert_array_equal(idx.numpy(), ridx)
    np.testing.assert_allclose(d2.numpy(), rd2, rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(m.numpy(), rm, atol=5e-6)
    np.testing.assert_allclose(nm.numpy(), rn, atol=5e-4)


@pytest.mark.parametrize("O,Pp,Ns,Nm", SHAPES)
def test_grouped_nn_matches_vmapped_pallas(O, Pp, Ns, Nm):
    q, r, _ = _clouds(O, Pp, Ns, Nm, seed=Nm)
    ridx, rd2 = jax.vmap(lambda qq, rr: knn_pallas.nn_batched(
        qq[None], rr, tile_s=64, tile_m=128, interpret=True))(
            jnp.asarray(q), jnp.asarray(r))
    idx, d2 = knn_cuda.nn_batched(_t(q), _t(r.reshape(O * Pp, Nm, 3)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx).reshape(O * Pp, Ns))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2).reshape(O * Pp, Ns),
                               rtol=1e-3, atol=1e-7)


@pytest.mark.parametrize("O,Pp,Ns,Nm", [(3, 4, 90, 130), (2, 3, 64, 70)])
def test_grouped_nn_gn_matches_vmapped_pallas(O, Pp, Ns, Nm):
    q, r, n = _clouds(O, Pp, Ns, Nm, seed=7)
    sn, w = _scene(O, Ns, seed=8)
    ref = jax.vmap(lambda *a: knn_pallas.nn_gn_batched(
        *a, **GATES, tile_s=64, tile_m=64, interpret=True))(
            *map(jnp.asarray, (q, sn, w, r, n)))
    out = knn_cuda.nn_gn_batched(_t(q), _t(sn), _t(w), _t(r.reshape(O * Pp, Nm, 3)),
                                 _t(n.reshape(O * Pp, Nm, 3)), **GATES)
    (H, g, wsum, hits, wrr) = (a.numpy() for a in out)
    Hr, gr, wsumr, hitsr, wrrr = (np.asarray(a).reshape((O * Pp,) + a.shape[2:])
                                  for a in ref)
    np.testing.assert_allclose(H, Hr, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(wsum, wsumr, rtol=1e-5)
    np.testing.assert_allclose(hits, hitsr, rtol=1e-5)
    np.testing.assert_allclose(wrr, wrrr, rtol=1e-4, atol=1e-8)
    # the nearly empty last object (4 points of weight) stays under the
    # freeze limit of 6 and takes nothing from its neighbours' scenes
    assert float(wsum[-Pp:].max()) <= 4.0 and float(wsum[:Pp].max()) > 6.0


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("O,Pp,Ns,Nm", SHAPES)
def test_grouped_plain_equals_loop_of_ungrouped_calls(O, Pp, Ns, Nm, ties):
    """One grouped call is bitwise the O ungrouped calls, ties included
    (the first minimal index wins in both)."""
    q, poses, model, model_n, r, n = _library(O, Pp, Ns, Nm, seed=3, ties=ties)
    sn, w = map(_t, _scene(O, Ns, seed=4))
    rf, nf = r.reshape(O * Pp, Nm, 3), n.reshape(O * Pp, Nm, 3)
    k1 = tuple(t.reshape((O * Pp,) + t.shape[2:])
               for t in knn_cuda.nn_gather_batched(q, poses, model, model_n))
    k2 = knn_cuda.nn_batched(q, rf)
    k3 = knn_cuda.nn_gn_batched(q, sn, w, rf, nf, **GATES)
    for o in range(O):
        sl = slice(o * Pp, (o + 1) * Pp)
        for grouped, alone in (
                (k1, knn_cuda.nn_gather_batched(q[o:o + 1], poses[o], model[o],
                                                model_n[o])),
                (k2, knn_cuda.nn_batched(q[o:o + 1], r[o])),
                (k3, knn_cuda.nn_gn_batched(q[o], sn[o], w[o], r[o], n[o], **GATES))):
            assert all(torch.equal(a[sl], b) for a, b in zip(grouped, alone))
    if ties:   # the lower index won: none from the duplicated half
        h = Nm // 2
        assert not bool(((k1[3] >= h) & (k1[3] < 2 * h)).any())


def test_drop_ins_take_the_library_form():
    """corr_fn on [O,P,4,4] poses with [O,Nm,3] model clouds, and nn_fn /
    gn_fn on [O,P,Nm,3] posed clouds, with one scene per object, or one for
    all, return [O,P,...] tensors equal to the folded plain calls on the
    clouds posed by se3."""
    O, Pp, Ns, Nm = 3, 4, 37, 73
    q, poses, model, model_n, r, n = _library(O, Pp, Ns, Nm, seed=11)
    sn, w = map(_t, _scene(O, Ns, seed=12))
    rf, nf = r.reshape(O * Pp, Nm, 3), n.reshape(O * Pp, Nm, 3)
    for query in (q, q[:1]):
        out = knn_cuda.make_corr_fn()(query, poses, model, model_n)
        ref = knn_cuda.nn_gather_plain(query, rf, nf)
        assert out[0].shape == (O, Pp, Ns, 3) and out[2].shape == (O, Pp, Ns)
        assert all(torch.equal(a.reshape(b.shape), b) for a, b in zip(out, ref))
        out = knn_cuda.make_nn_fn()(query, r)
        assert all(torch.equal(a.reshape(b.shape), b)
                   for a, b in zip(out, knn_cuda.nn_batched(query, rf)))
    out = knn_cuda.make_gn_fn(**GATES)(q, sn, w, r, n)
    assert out[0].shape == (O, Pp, 6, 6) and out[2].shape == (O, Pp)
    ref = knn_cuda.nn_gn_batched(q, sn, w, rf, nf, **GATES)
    assert all(torch.equal(a.reshape(b.shape), b) for a, b in zip(out, ref))


def test_grouped_shapes_are_validated():
    q, poses, model, model_n, r, n = _library(3, 4, 20, 30, seed=1)
    sn, w = map(_t, _scene(3, 20, seed=2))
    rf, nf = r.reshape(12, 30, 3), n.reshape(12, 30, 3)
    with pytest.raises(ValueError, match="does not divide"):
        knn_cuda.nn_gather_batched(q[:2].repeat(3, 1, 1)[:5], poses, model, model_n)
    with pytest.raises(ValueError, match="does not divide"):
        knn_cuda.nn_batched(q[:2].repeat(3, 1, 1)[:5], rf)
    with pytest.raises(ValueError, match="does not divide"):
        knn_cuda.nn_gn_batched(q.repeat(2, 1, 1)[:5], sn.repeat(2, 1, 1)[:5],
                               w.repeat(2, 1)[:5], rf, nf, **GATES)
