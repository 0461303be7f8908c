"""The Gauss-Newton tail of an ICP iteration: `icp.gn_iterate_plain` and
kernel K4 (`knn_cuda.gn_iterate_batched`).

On the CPU the plain version must be, bitwise, the step-by-step chain it
was moved from (`correspondence_weights`, `solve_gn_step`, the freezes,
`apply_twist_about` and the re-pose), and the wrapper must take it and
count no launch. On the card (cases marked `cuda`, skipped without a
device) K4 is held against the plain version at the main path's shapes:

- poses within 1e-5 (rotation entries, and metres): the kernel sums each
  particle's normal equations in another order than the plain version's
  batched product and reductions, and that rounding passes through up to
  three damped solves and pose updates, each of which scales it by the
  system's conditioning; 1e-5 holds it at a hundredth of a millimetre and
  about 1e-5 rad, far under the search's 2 cm gate;
- `frozen` equal: the gates and the freezes are the same comparisons;
- `rmse`, `inliers` and `support` within 1e-5 relative: one sum each, in
  another order (`inliers` and `support` sum exact 0/1 weights);
- a repeated call bitwise equal, and each object's group launched alone
  bitwise the grouped launch: every sum of a particle runs in one fixed
  order, set by Ns alone.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_gn_iterate.py
"""
import math

import pytest
import torch

from icra20_hand_object_pose_tpu_torch.ops import icp, knn_cuda
from icra20_hand_object_pose_tpu_torch.utils import se3

GATES = dict(max_corresp_dist=0.02, min_cos=math.cos(math.radians(60.0)),
             damping=1e-6, step_scale=1.0, converge_tol=1e-6)
SCALE = torch.tensor([0.04, 0.03, 0.05])


def _surface(g, shape):
    """Points on an ellipsoid of object size and their outward normals."""
    u = torch.nn.functional.normalize(torch.randn(shape + (3,), generator=g), dim=-1)
    return u * SCALE, torch.nn.functional.normalize(u / SCALE, dim=-1)


def _inputs(O, P, Ns, Nm, *, shared=False, seed=0, device="cpu"):
    """One ICP iteration's state after its search, built as `_icp_objects`
    builds it: O objects (one scene for all with `shared`), P particles each
    posed near the truth (every fifth frozen, the last one a metre off so
    that no pair passes the gate: zero inliers), K1's plain matches. The
    scene has padding rows (far off, weight 0) and points without normals."""
    g = torch.Generator().manual_seed(seed)
    model, mnrm = _surface(g, (O, Nm))
    truth = se3.apply_twist_about(
        torch.cat([torch.randn(O, 3, generator=g) * 0.3, torch.zeros(O, 3)], -1),
        torch.eye(4).repeat(O, 1, 1), torch.zeros(O, 3))
    truth[:, :3, 3] = torch.tensor([0.0, 0.0, 0.55])
    Gs = 1 if shared else O
    pts, nrm = _surface(g, (Gs, Ns))
    scene = se3.transform_points(truth[:Gs], pts) + torch.randn(Gs, Ns, 3, generator=g) * 1e-3
    snrm = se3.rotate_vectors(truth[:Gs], nrm)
    snrm[:, ::11] = 0.0
    scene[:, ::13] = 1e6
    sw = torch.ones(O, Ns)
    sw[:, ::13] = 0.0
    sw = sw * (torch.rand(O, Ns, generator=g) > 0.05)
    tw = torch.cat([torch.randn(O, P, 3, generator=g) * 0.03,
                    torch.randn(O, P, 3, generator=g) * 0.005], -1)
    poses = se3.apply_twist_about(tw, truth[:, None].expand(O, P, 4, 4),
                                  truth[:, None, :3, 3].expand(O, P, 3))
    poses[:, -1, 2, 3] += 1.0
    frozen = torch.zeros(O, P, dtype=torch.bool)
    frozen[:, ::5] = True
    wsum = torch.clamp(torch.sum(sw, dim=-1), min=1e-9)
    anchor = icp.weighted_sum(scene, sw) / wsum[:, None]
    scene_c = scene - anchor[:, None]
    posed = se3.transform_points(poses, model[:, None]).reshape(O * P, Nm, 3)
    pnrm = se3.rotate_vectors(poses, mnrm[:, None]).reshape(O * P, Nm, 3)
    scene, posed, pnrm = (a.to(device) for a in (scene, posed, pnrm))
    matched, mnorm, d2, _ = knn_cuda.nn_gather_plain(scene, posed, pnrm)
    return tuple(a.to(device) for a in (
        poses, frozen, matched.reshape(O, P, Ns, 3), mnorm.reshape(O, P, Ns, 3),
        d2.reshape(O, P, Ns), scene_c, snrm, sw, anchor, wsum))


def _stepwise(poses, frozen, matched, mnorm, d2, scene_c, snrm, sw, anchor, wsum, *,
              max_corresp_dist, min_cos, damping, step_scale, converge_tol, gn_reps,
              support_tau):
    """The chain written out from its parts, as the ICP loop ran it."""
    w = icp.correspondence_weights(d2, snrm[:, None], mnorm, sw[:, None],
                                   max_corresp_dist, min_cos)
    m_c, nrm = matched - anchor[:, None, None], mnorm
    for rep in range(gn_reps):
        xi, rmse = icp.solve_gn_step(scene_c[:, None], m_c, nrm, w, damping)
        xi = xi * step_scale
        frozen = frozen | (torch.sum(xi * xi, dim=-1) < converge_tol * converge_tol)
        xi = torch.where(frozen[..., None], 0.0, xi)
        poses = se3.apply_twist_about(xi, poses, anchor[:, None])
        if rep + 1 < gn_reps:
            E = se3.se3_exp(xi)
            m_c, nrm = se3.transform_points(E, m_c), se3.rotate_vectors(E, nrm)
    hit = (d2 < support_tau * support_tau).to(d2.dtype)
    support = (torch.sum(hit * sw[:, None], dim=-1) / wsum[:, None] if support_tau > 0
               else torch.zeros_like(d2[..., 0]))
    return poses, (rmse, torch.sum(w, dim=-1), frozen, support)


CPU_CASES = [  # (O, P, Ns, Nm, shared, gn_reps, support_tau)
    (1, 11, 60, 40, False, 1, 0.01), (1, 11, 60, 40, False, 3, 0.01),
    (3, 7, 50, 30, False, 3, 0.01), (3, 7, 50, 30, True, 3, 0.005),
    (3, 7, 50, 30, False, 1, 0.0), (1, 6, 45, 33, True, 3, 0.0),
]


@pytest.mark.parametrize("O,P,Ns,Nm,shared,reps,tau", CPU_CASES)
def test_plain_is_the_stepwise_chain(O, P, Ns, Nm, shared, reps, tau):
    """Bitwise the chain it was moved from, and the wrapper takes it on CPU
    tensors without counting a launch; the cases hold frozen particles, a
    zero-inlier one (frozen by its zero step) and support off."""
    args = _inputs(O, P, Ns, Nm, shared=shared, seed=O + reps)
    kw = dict(GATES, gn_reps=reps, support_tau=tau)
    want_poses, want = _stepwise(*args, **kw)
    before = knn_cuda.launch_counts()["gn_iterate_batched"]
    poses, st = knn_cuda.gn_iterate_batched(*args, **kw)
    assert knn_cuda.launch_counts()["gn_iterate_batched"] == before
    assert torch.equal(poses, want_poses)
    assert all(torch.equal(a, b) for a, b in zip(st, want))
    assert bool(st.converged[:, ::5].all()) and bool(st.converged[:, -1].all())
    assert bool((st.inliers[:, -1] == 0).all()) and bool((st.inliers[:, :-1] > 6).all())
    assert torch.equal(poses[:, ::5, :3, :3], args[0][:, ::5, :3, :3])
    assert bool((st.support > 0).any()) == (tau > 0)


@pytest.mark.parametrize("shared", [False, True])
def test_plain_object_alone_equals_library(shared):
    """Object o of a library gives, bitwise, what object o gives alone."""
    args = _inputs(3, 6, 50, 30, shared=shared, seed=5)
    kw = dict(GATES, gn_reps=3, support_tau=0.01)
    poses, st = icp.gn_iterate_plain(*args, **kw)
    for o in range(3):
        one = tuple(a[o:o + 1] if a.shape[0] == 3 else a for a in args)
        p1, s1 = icp.gn_iterate_plain(*one, **kw)
        assert torch.equal(p1[0], poses[o])
        assert all(torch.equal(a[0], b[o]) for a, b in zip(s1, st))


def test_icp_batched_runs_the_plain_tail():
    """icp_batched's iteration is the search followed by this tail: two
    iterations by hand equal icp_batched(iters=2) bitwise."""
    poses, frozen, _, _, _, scene_c, snrm, sw, _, _ = _inputs(2, 5, 40, 30, seed=3)
    g = torch.Generator().manual_seed(9)
    model, mnrm = _surface(g, (2, 30))
    scene = scene_c + 0.5
    wsum = torch.clamp(torch.sum(sw, dim=-1), min=1e-9)
    anchor = icp.weighted_sum(scene, sw) / wsum[:, None]
    scene_c = scene - anchor[:, None]
    kw = dict(GATES, gn_reps=3, support_tau=0.01)
    want, st = icp.icp_batched(poses, scene, snrm, sw, model, mnrm, iters=2,
                               max_corresp_dist=kw["max_corresp_dist"],
                               normal_angle_max_deg=60.0, damping=kw["damping"],
                               gn_reps=3, support_tau=0.01)
    p, fz = poses, torch.zeros_like(frozen)
    for _ in range(2):
        posed = se3.transform_points(p, model[:, None])
        pn = se3.rotate_vectors(p, mnrm[:, None])
        m, n, d2, _ = knn_cuda.nn_gather_plain(scene, posed.reshape(10, 30, 3),
                                               pn.reshape(10, 30, 3))
        p, s = icp.gn_iterate_plain(p, fz, m.reshape(2, 5, 40, 3), n.reshape(2, 5, 40, 3),
                                    d2.reshape(2, 5, 40), scene_c, snrm, sw, anchor, wsum, **kw)
        fz = s.converged
    assert torch.equal(p, want)
    assert all(torch.equal(a, b) for a, b in zip(s, st))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (O, P, Ns, Nm, shared): the tracked scan, the explorer pulls, the polish,
# the init scan, a sweep of 8 with a scene per object (tracked scan), the
# shared-scene library, and ragged cases (Ns above the small block, and
# one no block size divides)
CUDA_CASES = [(1, 512, 512, 256, False), (1, 32, 512, 256, False),
              (1, 18, 2048, 1024, False), (1, 1024, 512, 512, False),
              (8, 512, 512, 256, False), (8, 32, 512, 256, True),
              (3, 5, 777, 100, False), (2, 3, 37, 73, True)]


def _close(a, b, rel):
    return bool(((a - b).abs() <= rel * b.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("O,P,Ns,Nm,shared", CUDA_CASES)
@pytest.mark.parametrize("reps", [1, 3])
def test_cuda_gn_iterate_matches_plain(cuda_device, O, P, Ns, Nm, shared, reps):
    args = _inputs(O, P, Ns, Nm, shared=shared, seed=Ns + P, device=cuda_device)
    kw = dict(GATES, gn_reps=reps, support_tau=0.01)
    before = knn_cuda.launch_counts()["gn_iterate_batched"][0]
    poses, st = knn_cuda.gn_iterate_batched(*args, **kw)
    pp, sp = icp.gn_iterate_plain(*args, **kw)
    torch.cuda.synchronize()
    launches, shapes = knn_cuda.launch_counts()["gn_iterate_batched"]
    assert launches == before + 1
    assert shapes[(O * P, O, Ns)] >= 1
    assert bool(torch.isfinite(poses).all())
    assert (poses - pp).abs().max().item() <= 1e-5
    assert torch.equal(st.converged, sp.converged)
    assert _close(st.rmse, sp.rmse, 1e-5)
    assert _close(st.inliers, sp.inliers, 1e-5)
    assert _close(st.support, sp.support, 1e-5)
    again = knn_cuda.gn_iterate_batched(*args, **kw)
    assert torch.equal(again[0], poses) and all(torch.equal(a, b) for a, b in zip(again[1], st))
    if O > 1:
        for o in range(O):
            one = tuple(a[o:o + 1] if a.shape[0] == O else a for a in args)
            p1, s1 = knn_cuda.gn_iterate_batched(*one, **kw)
            assert torch.equal(p1[0], poses[o])
            assert all(torch.equal(a[0], b[o]) for a, b in zip(s1, st))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_gn_iterate_planar_systems_stay_finite(cuda_device, seed):
    """A flat patch: every scene normal alike, so H has rank 3 and the
    damped pivots of its null directions sit at FP32 rounding, where the
    reference's 1e-20 clamp solves to inf - inf. The port's pivot floor (the
    damping) keeps K4's three solves finite, as the plain version's."""
    args = list(_inputs(1, 256, 512, 256, seed=seed, device=cuda_device))
    n = torch.nn.functional.normalize(torch.tensor([0.2, -0.1, 1.0]), dim=0).to(cuda_device)
    args[3] = n.expand_as(args[3]).contiguous()           # model normals
    args[6] = n.expand_as(args[6]).contiguous()           # scene normals
    kw = dict(GATES, gn_reps=3, support_tau=0.01)
    poses, st = knn_cuda.gn_iterate_batched(*args, **kw)
    pp, _ = icp.gn_iterate_plain(*args, **kw)
    assert bool(torch.isfinite(poses).all()) and bool(torch.isfinite(st.rmse).all())
    assert bool(torch.isfinite(pp).all())
