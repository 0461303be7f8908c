"""Kernels K1, K2 and K3 on the card, each against its plain PyTorch version
at the shapes the port's paths give it, plus a ragged case.

- K1, which takes each particle's pose and its object's model cloud and
  poses the cloud itself: against `se3.transform_points` /
  `rotate_vectors` on the card followed by the plain version (the route
  that posed the clouds in ATen before the search), the same indices and
  bitwise-equal d2 (both compute the same FP32 operations and keep the
  first minimal index), and bitwise-equal matched points and normals. The
  library cases read each object's cloud from a slice of a longer one (an
  object stride).
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

The cases are marked `cuda` and skip without a CUDA device; the CPU cases
at the end hold the wrappers' CPU routes, K1's `corr_fn` and the ICP that
calls it to the route that posed the clouds with se3 first, bitwise. This
file imports neither jax nor the JAX package, so it also runs where only
the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_knn_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu_torch.ops import icp, knn_cuda
from icra20_hand_object_pose_tpu_torch.utils import se3


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


def _poses(lead, seed):
    """Poses of shape lead + (4, 4): rotations of up to ~1 rad, translations
    of 10 cm."""
    g = np.random.default_rng(seed)
    w = torch.tensor(g.normal(scale=0.6, size=lead + (3,)), dtype=torch.float32)
    t = torch.tensor(g.uniform(-0.1, 0.1, lead + (3,)), dtype=torch.float32)
    return se3.make_pose(se3.so3_exp(w), t)


def _k1_inputs(Pq, P, Ns, Nm, O=1, seed=0, ties=False, device="cpu"):
    """K1's inputs: queries [Pq,Ns,3], poses [P,4,4] (O == 1) or
    [O,P/O,4,4], and model clouds and normals [Nm,3] or [O,Nm,3], each
    object's a slice of a cloud of Nm + 5 points (the sweep's `[:, :km]`)."""
    q, r, n = (torch.tensor(a) for a in _clouds(Pq, O, Ns, Nm + 5, seed=seed))
    if ties:
        _ties(r[:, :Nm])
    poses = _poses((P,) if O == 1 else (O, P // O), seed + 1)
    m, mn = r[:, :Nm], n[:, :Nm]
    if O == 1:
        m, mn = m[0], mn[0]
    return tuple(t.to(device) for t in (q, poses, m, mn))


def _posed_route(query, poses, model, normals):
    """The route K1 replaced: the clouds posed by se3, then the plain K1, on
    the leading axes of `poses`."""
    if poses.dim() == 4 and model.dim() == 3:
        model, normals = model[:, None], normals[:, None]
    return knn_cuda._unfold(knn_cuda.nn_gather_plain(
        query, knn_cuda._fold(se3.transform_points(poses, model)),
        knn_cuda._fold(se3.rotate_vectors(poses, normals))), poses)


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
    # a query per group of particles is a library: one object per query
    O = Pq if 1 < Pq < P else 1
    args = _k1_inputs(Pq, P, Ns, Nm, O, ties=ties, device=cuda_device)
    before, before_shapes = knn_cuda.launch_counts()["nn_gather_batched"]
    m, nm, d2, idx = knn_cuda.nn_gather_batched(*args, plan=plan)
    mp, nmp, d2p, idxp = _posed_route(*args)
    torch.cuda.synchronize()
    launches, shapes = knn_cuda.launch_counts()["nn_gather_batched"]
    assert launches == before + 1
    assert shapes[(P, Pq, Ns, Nm)] == before_shapes[(P, Pq, Ns, Nm)] + 1
    assert torch.equal(idx, idxp) and torch.equal(d2, d2p)
    assert torch.equal(m, mp) and torch.equal(nm, nmp)


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(cuda_device):
    q, poses, m, n = _k1_inputs(1, 2, 8, 16, device=cuda_device)
    with pytest.raises(TypeError):
        knn_cuda.nn_gather_batched(q.double(), poses, m, n)
    with pytest.raises(ValueError):
        knn_cuda.nn_gather_batched(q, poses, m, n.cpu())
    with pytest.raises(ValueError):
        knn_cuda.nn_gather_batched(q, poses[:, :3], m, n)
    with pytest.raises(ValueError):     # two clouds for one object's particles
        knn_cuda.nn_gather_batched(q, poses, m.expand(2, 16, 3), n.expand(2, 16, 3))


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
    k1_args = _k1_inputs(1, 3, 20, 30)
    gn_args = [torch.tensor(a) for a in _gn_inputs(3, 20, 30)]
    gates = dict(maxd2=0.02 ** 2, min_cos=0.5, tau2=0.01 ** 2)
    before = knn_cuda.launch_counts()
    out = (knn_cuda.nn_gather_batched(*k1_args) + knn_cuda.nn_batched(q, r)
           + knn_cuda.nn_gn_batched(*gn_args, **gates))
    ref = (_posed_route(*k1_args) + knn_cuda.nn_plain(q, r)
           + knn_cuda.nn_gn_plain(*gn_args, **gates))
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert knn_cuda.launch_counts() == before


# (Pq, P, Ns, Nm, O, ties): one object with a shared and a per-particle
# query, a library of 3 with a query per object and one shared, ties
CORR_CASES = [(1, 6, 40, 70, 1, False), (6, 6, 40, 70, 1, False),
              (3, 12, 37, 73, 3, False), (1, 12, 37, 73, 3, True)]


@pytest.mark.parametrize("Pq,P,Ns,Nm,O,ties", CORR_CASES)
def test_cpu_corr_fn_is_the_posed_route(Pq, P, Ns, Nm, O, ties):
    """`make_corr_fn`'s corr_fn on the CPU, handed the poses and the model
    cloud (a scene [Ns,3] where there is one query), gives bitwise the
    route that posed the clouds with se3 and searched them with the plain
    K1, on the leading axes of the poses."""
    q, poses, m, n = _k1_inputs(Pq, P, Ns, Nm, O, seed=Ns, ties=ties)
    out = knn_cuda.make_corr_fn()(q[0] if Pq == 1 else q, poses, m, n)
    ref = _posed_route(q, poses, m, n)
    assert out[0].shape == poses.shape[:-2] + (Ns, 3)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def _icp_problem(O, P, seed=3):
    """A small ICP library: O ellipsoid-like model clouds of 200 points
    (normals along the position) and their scenes, the first 150 points
    posed by a ground truth with noise, and P starts per object perturbed
    from it by up to ~3 degrees and 5 mm."""
    g = np.random.default_rng(seed)
    d = g.normal(size=(O, 200, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    model = torch.tensor(d * [0.05, 0.03, 0.02], dtype=torch.float32)
    normals = torch.tensor(d, dtype=torch.float32)
    gt = _poses((O,), seed)
    scene = se3.transform_points(gt, model[:, :150]) + torch.tensor(
        g.normal(scale=5e-4, size=(O, 150, 3)), dtype=torch.float32)
    scene_n = se3.rotate_vectors(gt, normals[:, :150])
    w = torch.ones((O, 150))
    w[:, ::9] = 0.0
    xi = torch.tensor(np.concatenate([g.normal(scale=0.03, size=(O, P, 3)),
                                      g.normal(scale=0.003, size=(O, P, 3))], -1),
                      dtype=torch.float32)
    return se3.apply_twist(xi, gt[:, None]), scene, scene_n, w, model, normals


def _posed_corr_fn(scene, poses, model, normals):
    """A corr_fn by the route K1 replaced: se3's posing, then the plain K1."""
    q = scene[None] if scene.dim() == 2 else scene
    return _posed_route(q, poses, model, normals)


@pytest.mark.parametrize("O,gn_reps", [(1, 1), (3, 1), (3, 2)])
def test_cpu_icp_and_support_are_the_posed_route(O, gn_reps):
    """icp_batched and scene_support through K1's corr_fn on the CPU give
    bitwise what they gave when the ICP posed the clouds with se3 and
    handed them to the search: a single object (O = 1, unlifted) and a
    library of 3, whose model clouds are read from a slice."""
    poses0, scene, scene_n, w, model, normals = _icp_problem(O, 5)
    km = 160
    args = (scene, scene_n, w, model[:, :km], normals[:, :km])
    if O == 1:
        poses0, args = poses0[0], tuple(a[0] for a in args)
    kw = dict(iters=6, max_corresp_dist=0.02, gn_reps=gn_reps, support_tau=0.004)
    out = icp.icp_batched(poses0, *args, corr_fn=knn_cuda.make_corr_fn(), **kw)
    ref = icp.icp_batched(poses0, *args, corr_fn=_posed_corr_fn, **kw)
    assert torch.equal(out[0], ref[0])
    assert all(torch.equal(a, b) for a, b in zip(out[1], ref[1]))
    assert bool((out[1].inliers > 6.0).all())
    sup_args = (args[0], args[2], args[3], args[4])
    sup = icp.scene_support(out[0], *sup_args, tau=0.004, corr_fn=knn_cuda.make_corr_fn())
    sup_ref = icp.scene_support(out[0], *sup_args, tau=0.004, corr_fn=_posed_corr_fn)
    assert torch.equal(sup, sup_ref) and bool((sup > 0.5).all())
