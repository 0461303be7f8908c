"""Kernel K1 on the card: the CUDA kernel against its plain PyTorch version
at the tracked frame's shapes, shared and per-particle queries, plus a
ragged case. d2 within rtol 1e-5 / atol 1e-8 (both compute the same FP32
operations), >= 99.9% equal indices, and bitwise-equal matched points and
normals where the index agrees.

The cases are marked `cuda` and skip without a CUDA device. This file
imports neither jax nor the JAX package, so it also runs where only the
port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""
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
