"""Kernel K1 (fused NN + correspondence gather) in the port: its plain
PyTorch version against the JAX package's Pallas kernel (interpret mode, as
tests/test_knn_pallas.py runs it) and dense oracle, at that file's
tolerances: d2 rtol 1e-3 / atol 1e-7, matched points 5e-6 (the Pallas
gather is double-bf16), normals 5e-4. K1 takes the poses and the model
cloud; the Pallas kernel and the oracle take the clouds posed by
`se3.transform_points` / `rotate_vectors`. The CUDA kernel itself is
checked against the plain version in test_torch_knn_cuda.py, on the
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.ops import knn as jknn
from icra20_hand_object_pose_tpu.ops import knn_pallas
from icra20_hand_object_pose_tpu_torch.ops import knn, knn_cuda
from icra20_hand_object_pose_tpu_torch.utils import se3

torch.set_num_threads(2)


def _clouds(Pq, P, Ns, Nm, seed=0):
    g = np.random.default_rng(seed)
    q = g.uniform(-0.3, 0.3, (Pq, Ns, 3)).astype(np.float32)
    r = g.uniform(-0.3, 0.3, (P, Nm, 3)).astype(np.float32)
    n = g.normal(size=(P, Nm, 3)).astype(np.float32)
    return q, r, n / np.linalg.norm(n, axis=-1, keepdims=True)


def _posed(P, Nm, seed=0):
    """P poses [P,4,4] (rotations of up to ~1 rad, translations of 10 cm),
    a model cloud and its normals [Nm,3], and the cloud and normals posed
    by each pose [P,Nm,3] (numpy)."""
    g = np.random.default_rng(seed)
    w = torch.tensor(g.normal(scale=0.6, size=(P, 3)), dtype=torch.float32)
    t = torch.tensor(g.uniform(-0.1, 0.1, (P, 3)), dtype=torch.float32)
    poses = se3.make_pose(se3.so3_exp(w), t)
    _, m, mn = (torch.tensor(a[0]) for a in _clouds(1, 1, 1, Nm, seed=seed + 1))
    return (poses, m, mn, se3.transform_points(poses, m).numpy(),
            se3.rotate_vectors(poses, mn).numpy())


@pytest.mark.parametrize("Pq,P,Ns,Nm", [
    (1, 3, 40, 70),     # shared query
    (3, 3, 40, 70),     # per-particle query
    (1, 2, 37, 73),     # ragged, shared
    (2, 2, 100, 200),   # ragged over several tiles
])
def test_plain_k1_matches_pallas_and_dense(Pq, P, Ns, Nm):
    q = _clouds(Pq, P, Ns, Nm, seed=Ns + Nm)[0]
    poses, model, model_n, r, n = _posed(P, Nm, seed=Ns + Nm)
    mj, nj, d2j, _ = knn_pallas.nn_gather_batched(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(n),
        tile_s=64, tile_m=64, interpret=True)
    m, nm, d2, idx = knn_cuda.nn_gather_batched(torch.tensor(q), poses, model, model_n)
    assert idx.dtype == torch.int32 and int(idx.max()) < Nm
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2j), rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), atol=5e-6)
    np.testing.assert_allclose(nm.numpy(), np.asarray(nj), atol=5e-4)
    for p in range(P):
        ref_idx, ref_d2 = jknn.nn(jnp.asarray(q[0 if Pq == 1 else p]),
                                  jnp.asarray(r[p]))
        np.testing.assert_allclose(d2[p].numpy(), np.asarray(ref_d2),
                                   rtol=1e-3, atol=1e-7)
        np.testing.assert_allclose(m[p].numpy(), r[p][np.asarray(ref_idx)],
                                   atol=5e-6)


def test_dense_oracle_matches_reference():
    q, r, _ = _clouds(1, 3, 50, 80, seed=1)
    idx, d2 = knn.nn(torch.tensor(q[0]), torch.tensor(r))      # [3,50]
    for p in range(3):
        ref_idx, ref_d2 = jknn.nn(jnp.asarray(q[0]), jnp.asarray(r[p]))
        np.testing.assert_allclose(d2[p].numpy(), np.asarray(ref_d2),
                                   rtol=1e-3, atol=1e-7)
        assert np.mean(idx[p].numpy() == np.asarray(ref_idx)) > 0.99
    np.testing.assert_allclose(
        knn.pairwise_sqdist(torch.tensor(q[0]), torch.tensor(r[0])).numpy(),
        np.asarray(jknn.pairwise_sqdist(jnp.asarray(q[0]), jnp.asarray(r[0]))),
        rtol=1e-3, atol=1e-7)
    out = knn.nn_gather(torch.tensor(q[0]), torch.tensor(r[0]), torch.tensor(r[1]))
    ref = jknn.nn_gather(jnp.asarray(q[0]), jnp.asarray(r[0]), jnp.asarray(r[1]))
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-3, atol=1e-7)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)


def test_first_minimal_index_and_far_padding():
    """Exact ties keep the first index; 1e6 scene padding stays finite."""
    q = torch.tensor([[[0.0, 0.0, 0.0], [1e6, 1e6, 1e6]]])
    r = torch.tensor([[[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0],
                       [1.0, 1.0, 1.0]]])
    n = torch.eye(3)[[0, 1, 2, 0]][None]
    m, nm, d2, idx = knn_cuda.nn_gather_batched(q, torch.eye(4)[None], r, n)
    assert idx.tolist() == [[0, 3]]
    assert torch.isfinite(d2).all() and float(d2[0, 0]) == 1.0
    np.testing.assert_array_equal(m[0, 1].numpy(), [1.0, 1.0, 1.0])


def test_wrapper_rejects_bad_batches():
    q = torch.tensor(_clouds(2, 3, 10, 20)[0])
    poses, m, mn, _, _ = _posed(3, 20)
    with pytest.raises(ValueError):
        knn_cuda.nn_gather_batched(q, poses, m, mn)
    corr = knn_cuda.make_corr_fn()
    out = corr(q[0], poses, m, mn)
    assert out[0].shape == (3, 10, 3) and out[2].shape == (3, 10)
