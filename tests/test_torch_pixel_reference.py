"""The port's pixel-mode scorer (`ScoreConfig(mode="pixel")`: pso's fitness
function, and `knn_cuda.splat_compare_batched` beneath it) held against the
plain reference `portbench/reference/pixel.py`, which shares no code with
it, on seeded random poses and frames: 16 particles of 256 samples at 64 x
48, radius 1 and 2, with the hand in front of part of the object, a no-
return band (ghosts), a neutral band, particles partly and wholly outside the
frame, one behind the camera (an empty render), in the object form and the
library forms (a frame per object, one shared).

Counts are exact: the counted pixels (with the ghosts), and the coverage,
which is the exact match count over the exact valid count in one rounded
division. Sums are held to tolerances: the support within 1e-5 of
max(support, 1), since both sides add the same float32 terms (each in (0,
1], rounded alike) in different orders, and float32 sums of a few thousand
such terms part by a few units of 2^-24 of the total; the fitness, that sum
over the counted pixels (at least one), within 1e-5. A z-buffer of bf16
depths (the precision below the configuration's float32) must fail them.

On the card (cases marked `cuda`, skipped without a device) kernel K5 is
held to the same reference and to the ATen pair (`splat_compare_plain`), and
must be bitwise on repeat and for one object alone against the same object
in a library of 4. This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_pixel_reference.py
"""
import dataclasses
import math

import pytest
import torch

from icra20_hand_object_pose_tpu_torch.ops import knn_cuda, pso, render, score
from icra20_hand_object_pose_tpu_torch.utils import meshio, se3
from icra20_hand_object_pose_tpu_torch.utils.config import ScoreConfig
from portbench.reference import pixel

H, W, NR, P = 48, 64, 256, 16
CAM = dict(fx=57.6, fy=57.6, cx=32.0, cy=24.0)
CFG = ScoreConfig(mode="pixel")
GATES = dict(depth_tau=CFG.depth_tau, wrong_side_penalty=CFG.wrong_side_penalty,
             occlusion_margin=CFG.occlusion_margin, invalid_penalty=CFG.invalid_penalty)
BOX = meshio.make_test_object("box")


def _truth(g):
    """A box pose half a metre out, turned at random."""
    xi = torch.cat([torch.randn(3, generator=g) * 0.6, torch.zeros(3)])
    T = se3.se3_exp(xi)
    T[:3, 3] = torch.tensor([0.01, -0.01, 0.45]) + torch.randn(3, generator=g) * 0.01
    return T


def _frame(seed: int, ghost_dilate: int = 1):
    """(observed depth, valid, encoded, hand depth): the box rastered at a
    seeded pose in front of a wall, 1 mm noise, 3% dropout, a no-return
    band across the object, a neutral band, and the hand's near plane over
    part of it."""
    g = torch.Generator().manual_seed(seed)
    T = _truth(g)
    verts = se3.transform_points(T, torch.as_tensor(BOX.vertices, dtype=torch.float32))
    depth = render.raster_depth(verts, torch.as_tensor(BOX.faces), height=H, width=W, **CAM)
    depth = torch.where(torch.isfinite(depth), depth, torch.full_like(depth, 0.7))
    depth[:, 50:] = 0.0                                    # no return at the right
    depth = depth + torch.randn(H, W, generator=g) * 1e-3
    depth[20:23, 8:56] = 0.0                               # a no-return band
    valid = (depth > 0.1) & (torch.rand(H, W, generator=g) > 0.03)
    neutral = torch.zeros(H, W, dtype=torch.bool)
    neutral[30:32, 10:40] = True                           # segmented away
    valid = valid & ~neutral
    depth = torch.where(valid, depth, torch.zeros_like(depth))
    enc = score.encode_observed(depth, valid, ghost_dilate, neutral=neutral)
    hand = torch.full((H, W), float("inf"))
    hand[8:20, 28:44] = 0.40
    return depth, valid, enc, hand, T


def _poses(seed: int, T):
    """16 particles about T: 12 near it, one 25 cm aside (partly out of
    the frame), one a metre aside (wholly out), one behind the camera (an
    empty render) and one 5 cm from the lens (spread over the frame)."""
    g = torch.Generator().manual_seed(seed + 100)
    xi = torch.cat([torch.randn(P, 3, generator=g) * 0.1,
                    torch.randn(P, 3, generator=g) * 0.01], -1)
    xi[0] = 0.0
    poses = se3.apply_twist_about(xi, T.expand(P, 4, 4), T[:3, 3].expand(P, 3))
    poses[12, 0, 3] += 0.25
    poses[13, 0, 3] += 1.0
    poses[14, 2, 3] = -0.45
    poses[15, 2, 3] = 0.05
    return poses


def _samples(seed: int):
    pts, _ = BOX.sample_surface(NR, seed=seed)
    g = torch.Generator().manual_seed(seed + 7)
    w = (torch.rand(NR, generator=g) > 0.1).to(torch.float32)
    return torch.as_tensor(pts, dtype=torch.float32), w


def _assert_agree(terms, ref, where: str):
    """Counts exact, coverage exact, support and fitness within tolerance."""
    assert torch.equal(terms.counted, ref["counted"].to(torch.float32)), where
    assert torch.equal(terms.coverage, ref["coverage"]), where
    tol = 1e-5 * torch.clamp(ref["support"].abs(), min=1.0)
    assert bool(((terms.support - ref["support"]).abs() <= tol).all()), where
    assert bool(((terms.fitness - ref["fitness"]).abs() <= 1e-5).all()), where


def _reference(pts_cam, w, depth, valid, enc, hand, radius, **kw):
    return pixel.score(pts_cam, w, depth, valid, enc, hand, radius=radius, **CAM,
                       **GATES, **kw)


def _case(seed: int, radius: int, n_obj: int, shared: bool, ghost_dilate: int = 1):
    """n_obj objects (1: the object form), each its own frame unless shared:
    poses [O,P,4,4], samples [O,Nr,3], weights [O,Nr] and images [1|O,H,W]."""
    frames = [_frame(seed + o, ghost_dilate) for o in range(1 if shared else n_obj)]
    poses = torch.stack([_poses(seed + o, frames[0 if shared else o][4])
                         for o in range(n_obj)])
    samples = [_samples(seed + o) for o in range(n_obj)]
    pts = torch.stack([s[0] for s in samples])
    w = torch.stack([s[1] for s in samples])
    images = [torch.stack([f[k] for f in frames]) for k in range(4)]
    return poses, pts, w, images


def _kernel_terms(poses, pts, w, images, radius, ghost_dilate=1):
    depth, valid, enc, hand = images
    pts_cam = se3.transform_points(poses, pts[:, None])          # [O,P,Nr,3]
    return knn_cuda.splat_compare_batched(
        pts_cam, w[:, None], depth, valid, enc, hand, height=H, width=W,
        radius=radius, ghost_dilate=ghost_dilate, **CAM, **GATES), pts_cam


def _reference_terms(pts_cam, w, images, radius, **kw):
    depth, valid, enc, hand = images
    per = [_reference(pts_cam[o], w[o], depth[min(o, len(depth) - 1)],
                      valid[min(o, len(depth) - 1)], enc[min(o, len(depth) - 1)],
                      hand[min(o, len(depth) - 1)], radius, **kw)
           for o in range(pts_cam.shape[0])]
    return {k: torch.stack([p[k] for p in per]) for k in per[0]}


FORMS = [(1, False), (2, False), (3, True)]   # (objects, one frame shared)


@pytest.mark.parametrize("n_obj,shared", FORMS)
@pytest.mark.parametrize("radius", [1, 2])
def test_scorer_matches_the_reference(n_obj, shared, radius):
    """The scorer's terms of every particle against the reference's; the
    cases hold every kind of pixel and particle the semantics names."""
    poses, pts, w, images = _case(3 + radius, radius, n_obj, shared)
    terms, pts_cam = _kernel_terms(poses, pts, w, images, radius)
    ref = _reference_terms(pts_cam, w, images, radius)
    _assert_agree(terms, ref, f"O={n_obj} shared={shared} r={radius}")
    # every kind of pixel and particle is present
    assert int(ref["ghost"].sum()) > 0 and int(ref["wrong"].sum()) > 0
    assert int(ref["matches"][:, 0].min()) > 0                   # at the truth
    assert float((ref["matches"][:, :12] > 0).float().mean()) > 0.5
    assert bool((ref["counted"][:, 14] == 0).all())             # behind the camera
    assert bool((terms.fitness[:, 14] == -CFG.wrong_side_penalty).all())
    assert bool((ref["counted"][:, 13] == 0).all())             # out of the frame
    assert int(ref["counted"][:, 12].min()) > 0                  # partly out


@pytest.mark.parametrize("n_obj,shared", FORMS)
def test_fitness_function_matches_the_reference(n_obj, shared):
    """pso's fitness function in pixel mode (the object form for one
    object, the library form otherwise), hand and self-occlusion mask
    given: fitness + coverage_weight x coverage and coverage against the
    reference's."""
    poses, pts, w, images = _case(11, 1, n_obj, shared)
    depth, valid, enc, hand = images
    g = torch.Generator().manual_seed(5)
    mask = torch.rand(pts.shape[:2], generator=g) > 0.2
    kw = dict(splat_radius=1, score_cfg=CFG, height=H, width=W, **CAM)
    if n_obj == 1:
        fit, cov = pso.score_particles(poses[0], pts[0], pts[0], w[0], depth[0], valid[0],
                                       hand[0], observed_enc=enc[0], sample_mask=mask[0],
                                       **kw)
        fit, cov = fit[None], cov[None]
    else:
        fit, cov = pso.score_particles(poses, pts, pts, w, depth, valid, hand,
                                       observed_enc=enc, sample_mask=mask, **kw)
    pts_cam = se3.transform_points(poses, pts[:, None])
    ref = _reference_terms(pts_cam, w * mask, images, 1)
    assert torch.equal(cov, ref["coverage"])
    want = ref["fitness"] + CFG.coverage_weight * ref["coverage"]
    assert bool(((fit - want).abs() <= 1e-5).all())


@pytest.mark.parametrize("ghost_dilate", [0, 2])
def test_ghost_band_and_no_hand(ghost_dilate):
    """Another ghost band (none, 2 px) and no hand image, the observation
    not encoded: the wrapper encodes it itself, with no neutral pixels (a
    neutral band then reads as no return)."""
    poses, pts, w, images = _case(21, 1, 2, False, ghost_dilate)
    depth, valid, _, _ = images
    pts_cam = se3.transform_points(poses, pts[:, None])
    terms = knn_cuda.splat_compare_batched(
        pts_cam, w[:, None], depth, valid, None, None, height=H, width=W, radius=1,
        ghost_dilate=ghost_dilate, **CAM, **GATES)
    enc = score.encode_observed(depth, valid, ghost_dilate)
    ref = _reference_terms(pts_cam, w, [depth, valid, enc, [None] * 2], 1)
    _assert_agree(terms, ref, f"ghost_dilate={ghost_dilate}")


@pytest.mark.parametrize("radius", [1, 2])
def test_bf16_depths_fail(radius):
    """The control: a reference whose z-buffer holds bf16 depths disagrees
    beyond the tolerances, so the comparison would catch a render in the
    precision below float32."""
    poses, pts, w, images = _case(3 + radius, radius, 2, False)
    terms, pts_cam = _kernel_terms(poses, pts, w, images, radius)
    low = _reference_terms(pts_cam, w, images, radius, render_dtype=torch.bfloat16)
    with pytest.raises(AssertionError):
        _assert_agree(terms, low, "bf16")


def test_reference_in_blocks():
    """The reference in blocks of particles is the reference at once."""
    poses, pts, w, images = _case(4, 1, 1, False)
    pts_cam = se3.transform_points(poses[0], pts[0])
    args = (w[0], *(img[0] for img in images))
    whole = pixel.score(pts_cam, *args, radius=1, **CAM, **GATES)
    blocks = pixel.score_in_blocks(pts_cam, *args, block=5, radius=1, **CAM, **GATES)
    assert all(torch.equal(whole[k], blocks[k]) for k in whole)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _to(dev, poses, pts, w, images):
    return poses.to(dev), pts.to(dev), w.to(dev), [t.to(dev) for t in images]


@pytest.mark.cuda
@pytest.mark.parametrize("n_obj,shared", FORMS)
@pytest.mark.parametrize("radius", [1, 2])
def test_cuda_k5_matches_reference_and_aten(cuda_device, n_obj, shared, radius):
    """K5 against the reference and against the ATen pair on the card:
    counts and coverage exact, sums within the tolerances; a repeated
    launch bitwise equal."""
    case = _to(cuda_device, *_case(3 + radius, radius, n_obj, shared))
    before = knn_cuda.launch_counts()["splat_compare_batched"][0]
    terms, pts_cam = _kernel_terms(*case, radius)
    assert knn_cuda.launch_counts()["splat_compare_batched"][0] == before + 1
    _assert_agree(terms, _reference_terms(pts_cam, case[2], case[3], radius), "reference")
    depth, valid, enc, hand = case[3]
    aten = knn_cuda.splat_compare_plain(
        pts_cam, case[2][:, None], depth, valid, enc, hand, height=H, width=W,
        radius=radius, ghost_dilate=1, **CAM, **GATES)
    _assert_agree(terms, dict(aten._asdict(), counted=aten.counted), "ATen pair")
    again, _ = _kernel_terms(*case, radius)
    assert all(torch.equal(a, b) for a, b in zip(again, terms))


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True])
def test_cuda_k5_object_alone_equals_library(cuda_device, shared):
    """Object o of a library of 4 gets, bitwise, what it gets alone."""
    poses, pts, w, images = _to(cuda_device, *_case(8, 1, 4, shared))
    terms, _ = _kernel_terms(poses, pts, w, images, 1)
    for o in range(4):
        one = [img[o:o + 1] if img.shape[0] == 4 else img for img in images]
        alone, _ = _kernel_terms(poses[o:o + 1], pts[o:o + 1], w[o:o + 1], one, 1)
        assert all(torch.equal(a[0], b[o]) for a, b in zip(alone, terms))


@pytest.mark.cuda
def test_cuda_fitness_function_in_pixel_mode(cuda_device):
    """pso's fitness function in pixel mode launches K5 once a call and
    agrees with its CPU path."""
    poses, pts, w, images = _case(11, 1, 2, False)
    kw = dict(splat_radius=1, score_cfg=CFG, height=H, width=W, **CAM)
    cpu = pso.score_particles(poses, pts, pts, w, *images[:2], images[3],
                              observed_enc=images[2], **kw)
    poses, pts, w, images = _to(cuda_device, poses, pts, w, images)
    before = knn_cuda.launch_counts()["splat_compare_batched"][0]
    card = pso.score_particles(poses, pts, pts, w, *images[:2], images[3],
                               observed_enc=images[2], **kw)
    assert knn_cuda.launch_counts()["splat_compare_batched"][0] == before + 1
    assert torch.equal(card[1].cpu(), cpu[1])
    assert bool(((card[0].cpu() - cpu[0]).abs() <= 1e-5).all())
    assert math.isfinite(float(card[0].sum()))


def test_k5_shapes_and_routing():
    """On CPU tensors the wrapper takes the plain version and counts no
    launch; its weights and images are folded as the kernel takes them."""
    poses, pts, w, images = _case(2, 1, 2, False)
    before = knn_cuda.launch_counts()["splat_compare_batched"]
    _kernel_terms(poses, pts, w, images, 1)
    assert knn_cuda.launch_counts()["splat_compare_batched"] == before
    lead = (2, P)
    wr, per = knn_cuda._weight_rows(w[:, None], lead, NR)
    assert wr.shape == (2, NR) and per == P
    wr, per = knn_cuda._weight_rows(w[0], lead, NR)
    assert wr.shape == (1, NR) and per == 2 * P
    wr, per = knn_cuda._weight_rows(w[0].expand(P, NR), lead, NR)
    assert wr.shape == (2 * P, NR) and per == 1
    img, per = knn_cuda._image_blocks(images[0], lead, 2 * P)
    assert img.shape == (2, H, W) and per == P
    img, per = knn_cuda._image_blocks(images[0][0], (P,), P)
    assert img.shape == (1, H, W) and per == P
    with pytest.raises(ValueError):
        knn_cuda._image_blocks(images[0], (P,), P)


def test_mode_is_the_only_difference():
    """ScoreConfig(mode="pixel") keeps every other field of the default."""
    assert dataclasses.replace(CFG, mode="point") == ScoreConfig()
