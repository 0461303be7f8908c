"""Kernels K1, K2 and K3 on the card, each against its plain PyTorch version
at the shapes the port's paths give it, plus a ragged case.

- K1: the same indices and bitwise-equal d2 (both compute the same FP32
  operations and keep the first minimal index), and bitwise-equal matched
  points and normals.
- K2: the same indices and bitwise-equal d2.

Beyond the main-path shapes, the cases cover ties placed across the ranges
that a block's thread groups split the reference cloud into (the same
point at j and j + Nm/2: the lower index must win), Nm = 1, Nm that no
split divides, Ns that is no multiple of the query tile, reference ranges
larger than one shared-memory tile, and for K3 a scene larger than one
launch covers at once; and the grouped form, a query (scene) per group of
particles, at a library sweep's shapes (8 objects) and at ragged ones.
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


def _ties(r):
    """Copies the first half of each reference cloud ([P, Nm, 3]) over the
    second half: every minimum is then reached at j and at j + Nm // 2."""
    h = r.shape[1] // 2
    r[:, h:2 * h] = r[:, :h]
    return r


def _clouds(Pq, P, Ns, Nm, seed=0, ties=False):
    g = np.random.default_rng(seed)
    q = g.uniform(-0.3, 0.3, (Pq, Ns, 3)).astype(np.float32)
    r = g.uniform(-0.3, 0.3, (P, Nm, 3)).astype(np.float32)
    n = g.normal(size=(P, Nm, 3)).astype(np.float32)
    return q, _ties(r) if ties else r, n / np.linalg.norm(n, axis=-1, keepdims=True)


def _plan(q, groups, scene_split=1, width=knn_cuda.WIDTH):
    return knn_cuda.Plan(q, groups, scene_split, width)


# (Pq, P, Ns, Nm, ties, plan): the main-path shapes with their own plans,
# then ties across groups, Nm = 1, ragged splits and multi-tile ranges
NN_CASES = [
    (1, 512, 512, 256, False, None), (512, 512, 512, 256, False, None),
    (32, 32, 512, 256, False, None), (1, 18, 2048, 1024, False, None),
    (1, 1024, 512, 512, False, None), (1, 17, 2048, 1024, False, None),
    (3, 3, 37, 73, False, None),
    (1, 18, 2048, 1024, True, None), (1, 32, 512, 256, True, None),
    (1, 4, 300, 1, False, None), (1, 4, 300, 257, True, _plan(1, 2)),
    (1, 3, 777, 100, True, _plan(4, 4)), (2, 2, 1000, 3000, True, _plan(2, 2)),
    (1, 1, 64, 4099, True, _plan(1, 4)), (1, 5, 333, 1000, True, _plan(2, 3, 1, 64)),
    # a query per group of particles: the sweep's scans, explorers and polish
    (8, 4096, 512, 256, False, None), (8, 256, 512, 256, False, None),
    (8, 144, 2048, 1024, True, None), (8, 8192, 512, 512, False, None),
    (3, 12, 37, 73, True, None), (2, 6, 300, 257, True, _plan(1, 2)),
    (4, 8, 777, 1100, True, _plan(4, 4)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("Pq,P,Ns,Nm,ties,plan", NN_CASES)
def test_cuda_kernel_matches_plain(cuda_device, Pq, P, Ns, Nm, ties, plan):
    q, r, n = (torch.tensor(a, device=cuda_device)
               for a in _clouds(Pq, P, Ns, Nm, ties=ties))
    before, before_shapes = knn_cuda.launch_counts()["nn_gather_batched"]
    m, nm, d2, idx = knn_cuda.nn_gather_batched(q, r, n, plan=plan)
    mp, nmp, d2p, idxp = knn_cuda.nn_gather_plain(q, r, n)
    torch.cuda.synchronize()
    launches, shapes = knn_cuda.launch_counts()["nn_gather_batched"]
    assert launches == before + 1
    assert shapes[(P, Pq, Ns, Nm)] == before_shapes[(P, Pq, Ns, Nm)] + 1
    assert torch.equal(idx, idxp) and torch.equal(d2, d2p)
    assert torch.equal(m, mp) and torch.equal(nm, nmp)


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
@pytest.mark.parametrize("Pq,P,Ns,Nm,ties,plan", NN_CASES)
def test_cuda_nn_kernel_matches_plain(cuda_device, Pq, P, Ns, Nm, ties, plan):
    q, r, _ = (torch.tensor(a, device=cuda_device)
               for a in _clouds(Pq, P, Ns, Nm, ties=ties))
    before = knn_cuda.launch_counts()["nn_batched"][0]
    idx, d2 = knn_cuda.nn_batched(q, r, plan=plan)
    idxp, d2p = knn_cuda.nn_plain(q, r)
    torch.cuda.synchronize()
    assert knn_cuda.launch_counts()["nn_batched"][0] == before + 1
    assert idx.dtype == torch.int32 and idx.shape == (P, Ns)
    assert torch.equal(idx, idxp) and torch.equal(d2, d2p)


def _gn_inputs(P, Ns, Nm, seed=1, ties=False, G=None):
    """K3's inputs; with G the scene, its normals and weights get a leading
    group axis [G,Ns,...] and the last group is left nearly empty (under 6
    points of weight: its particles must freeze, and only they)."""
    g = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    scene = g.uniform(-0.05, 0.05, lead + (Ns, 3)).astype(np.float32)
    snrm = g.normal(size=lead + (Ns, 3)).astype(np.float32)
    snrm /= np.linalg.norm(snrm, axis=-1, keepdims=True)
    snrm[..., ::11, :] = 0.0
    w = (g.random(lead + (Ns,)) > 0.1).astype(np.float32)
    scene[..., ::13, :], w[..., ::13] = 1e6, 0.0      # padding rows
    if G is not None and G > 1:
        w[-1, 5:] = 0.0
    ref = g.uniform(-0.05, 0.05, (P, Nm, 3)).astype(np.float32)
    if ties:
        _ties(ref)
    rnrm = g.normal(size=(P, Nm, 3)).astype(np.float32)
    rnrm /= np.linalg.norm(rnrm, axis=-1, keepdims=True)
    return scene, snrm, w, ref, rnrm


@pytest.mark.cuda
@pytest.mark.parametrize("P,Ns,Nm,ties,plan,G", [
    (512, 512, 256, False, None, None), (32, 512, 256, False, None, None),
    (1024, 512, 512, False, None, None), (3, 90, 130, False, None, None),
    (32, 512, 256, True, None, None), (3, 4096, 256, False, None, None),
    (5, 1000, 700, True, _plan(4, 1), None), (2, 300, 2100, False, _plan(1, 2, 3), None),
    # a scene per group of particles: the sweep's scans and explorer pulls
    (4096, 512, 256, False, None, 8), (256, 512, 256, True, None, 8),
    (8192, 512, 512, False, None, 8), (12, 90, 130, True, None, 3),
    (6, 1000, 300, True, _plan(1, 2, 3), 2), (5, 90, 130, False, None, 5),
])
def test_cuda_gn_kernel_matches_plain(cuda_device, P, Ns, Nm, ties, plan, G):
    args = [torch.tensor(a, device=cuda_device)
            for a in _gn_inputs(P, Ns, Nm, ties=ties, G=G)]
    gates = dict(maxd2=0.02 ** 2, min_cos=math.cos(math.radians(60.0)),
                 tau2=0.01 ** 2)
    before = knn_cuda.launch_counts()["nn_gn_batched"][0]
    H, g, wsum, hits, wrr = knn_cuda.nn_gn_batched(*args, **gates, plan=plan)
    Hp, gp, wsump, hitsp, wrrp = knn_cuda.nn_gn_plain(*args, **gates)
    torch.cuda.synchronize()
    assert knn_cuda.launch_counts()["nn_gn_batched"][0] == before + 1
    scale = Hp.abs().amax(dim=(1, 2))
    for a, b in ((H, Hp), (g, gp), (wrr, wrrp)):
        sc = scale.reshape((P,) + (1,) * (a.dim() - 1))
        assert bool(((a - b).abs() <= 1e-4 * b.abs() + 1e-5 * sc).all())
    for a, b in ((wsum, wsump), (hits, hitsp)):
        assert bool(((a - b).abs() <= 1e-5 * b.abs()).all())
    # bitwise reproducible: every sum runs in a fixed order
    again = knn_cuda.nn_gn_batched(*args, **gates, plan=plan)
    assert all(torch.equal(x, y) for x, y in zip(again, (H, g, wsum, hits, wrr)))
    if G is not None and G > 1:
        # a group's sums hold its own scene only: the nearly empty last
        # group stays at 5 points of weight or under, and each group alone
        # (an ungrouped launch on its particles, each with its default plan
        # when none is given) gives the same bits
        per = P // G
        assert bool((wsum[-per:] <= 5.0).all())
        for o in range(G):
            sl = slice(o * per, (o + 1) * per)
            alone = knn_cuda.nn_gn_batched(
                args[0][o], args[1][o], args[2][o], args[3][sl].contiguous(),
                args[4][sl].contiguous(), **gates, plan=plan)
            assert all(torch.equal(x[sl], y)
                       for x, y in zip((H, g, wsum, hits, wrr), alone))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    """On CPU tensors each wrapper returns its plain version's result, and
    `launch_counts()` does not move: it counts kernel launches only."""
    q, r, n = (torch.tensor(a) for a in _clouds(1, 3, 20, 30))
    gn_args = [torch.tensor(a) for a in _gn_inputs(3, 20, 30)]
    gates = dict(maxd2=0.02 ** 2, min_cos=0.5, tau2=0.01 ** 2)
    before = knn_cuda.launch_counts()
    out = (knn_cuda.nn_gather_batched(q, r, n) + knn_cuda.nn_batched(q, r)
           + knn_cuda.nn_gn_batched(*gn_args, **gates))
    ref = (knn_cuda.nn_gather_plain(q, r, n) + knn_cuda.nn_plain(q, r)
           + knn_cuda.nn_gn_plain(*gn_args, **gates))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert knn_cuda.launch_counts() == before
