"""Kernels K1, K2 and K3 on the card, each against its plain PyTorch version
at the shapes the port's paths give it, plus a ragged case.

- K1: d2 within rtol 1e-5 / atol 1e-8 (both compute the same FP32
  operations), >= 99.9% equal indices, and bitwise-equal matched points and
  normals where the index agrees.
- K2: >= 99.9% equal indices, d2 bitwise equal where the index agrees.
- K3: H, g and wrr within rtol 1e-4 plus an atol of 1e-5 x the largest |H|
  entry of that particle (the sums run in other orders); wsum and hits
  within 1e-5 relative.

The cases are marked `cuda` and skip without a CUDA device. This file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu_torch.ops import knn_cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _clouds(Pq, P, Ns, Nm, seed=0):
    g = np.random.default_rng(seed)
    q = g.uniform(-0.3, 0.3, (Pq, Ns, 3)).astype(np.float32)
    r = g.uniform(-0.3, 0.3, (P, Nm, 3)).astype(np.float32)
    n = g.normal(size=(P, Nm, 3)).astype(np.float32)
    return q, r, n / np.linalg.norm(n, axis=-1, keepdims=True)


@pytest.mark.cuda
@pytest.mark.parametrize("Pq,P,Ns,Nm", [(1, 512, 512, 256), (512, 512, 512, 256),
                                        (1, 18, 2048, 1024), (3, 3, 37, 73)])
def test_cuda_kernel_matches_plain(cuda_device, Pq, P, Ns, Nm):
    q, r, n = (torch.tensor(a, device=cuda_device) for a in _clouds(Pq, P, Ns, Nm))
    before = knn_cuda.nn_gather_batched.launches
    m, nm, d2, idx = knn_cuda.nn_gather_batched(q, r, n)
    mp, nmp, d2p, idxp = knn_cuda.nn_gather_plain(q, r, n)
    torch.cuda.synchronize()
    assert knn_cuda.nn_gather_batched.launches == before + 1
    torch.testing.assert_close(d2, d2p, rtol=1e-5, atol=1e-8)
    same = idx == idxp
    assert same.float().mean().item() >= 0.999
    assert torch.equal(m[same], mp[same]) and torch.equal(nm[same], nmp[same])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    q, r, n = (torch.tensor(a, device=cuda_device) for a in _clouds(1, 2, 8, 16))
    with pytest.raises(TypeError):
        knn_cuda.nn_gather_batched(q.double(), r, n)
    with pytest.raises(ValueError):
        knn_cuda.nn_gather_batched(q, r, n.cpu())
    with pytest.raises(ValueError):
        knn_cuda.nn_gather_batched(q, r.transpose(0, 1).contiguous().transpose(0, 1), n)


@pytest.mark.cuda
@pytest.mark.parametrize("Pq,P,Ns,Nm", [(1, 512, 512, 256), (32, 32, 512, 256),
                                        (1, 18, 2048, 1024), (3, 3, 37, 73)])
def test_cuda_nn_kernel_matches_plain(cuda_device, Pq, P, Ns, Nm):
    q, r, _ = (torch.tensor(a, device=cuda_device) for a in _clouds(Pq, P, Ns, Nm))
    before = knn_cuda.nn_batched.launches
    idx, d2 = knn_cuda.nn_batched(q, r)
    idxp, d2p = knn_cuda.nn_plain(q, r)
    torch.cuda.synchronize()
    assert knn_cuda.nn_batched.launches == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (P, Ns)
    same = idx == idxp
    assert same.float().mean().item() >= 0.999
    assert torch.equal(d2[same], d2p[same])


def _gn_inputs(P, Ns, Nm, seed=1):
    g = np.random.default_rng(seed)
    scene = g.uniform(-0.05, 0.05, (Ns, 3)).astype(np.float32)
    snrm = g.normal(size=(Ns, 3)).astype(np.float32)
    snrm /= np.linalg.norm(snrm, axis=-1, keepdims=True)
    snrm[::11] = 0.0
    w = (g.random(Ns) > 0.1).astype(np.float32)
    scene[::13], w[::13] = 1e6, 0.0                   # padding rows
    ref = g.uniform(-0.05, 0.05, (P, Nm, 3)).astype(np.float32)
    rnrm = g.normal(size=(P, Nm, 3)).astype(np.float32)
    rnrm /= np.linalg.norm(rnrm, axis=-1, keepdims=True)
    return scene, snrm, w, ref, rnrm


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ns,Nm", [(512, 512, 256), (32, 512, 256),
                                     (1024, 512, 512), (3, 90, 130)])
def test_cuda_gn_kernel_matches_plain(cuda_device, P, Ns, Nm):
    args = [torch.tensor(a, device=cuda_device) for a in _gn_inputs(P, Ns, Nm)]
    gates = dict(maxd2=0.02 ** 2, min_cos=math.cos(math.radians(60.0)),
                 tau2=0.01 ** 2)
    before = knn_cuda.nn_gn_batched.launches
    H, g, wsum, hits, wrr = knn_cuda.nn_gn_batched(*args, **gates)
    Hp, gp, wsump, hitsp, wrrp = knn_cuda.nn_gn_plain(*args, **gates)
    torch.cuda.synchronize()
    assert knn_cuda.nn_gn_batched.launches == before + 1
    scale = Hp.abs().amax(dim=(1, 2))
    for a, b in ((H, Hp), (g, gp), (wrr, wrrp)):
        sc = scale.reshape((P,) + (1,) * (a.dim() - 1))
        assert bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * sc).all())
    for a, b in ((wsum, wsump), (hits, hitsp)):
        assert bool(((a - b).abs() <= 1e-5 * b.abs()).all())
    # bitwise reproducible: no atomics
    again = knn_cuda.nn_gn_batched(*args, **gates)
    assert all(torch.equal(x, y) for x, y in zip(again, (H, g, wsum, hits, wrr)))
