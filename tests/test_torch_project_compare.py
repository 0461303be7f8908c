"""The point-mode projective scorer: `knn_cuda.project_compare_plain` and
kernel K6 (`knn_cuda.project_compare_batched`).

On the CPU the wrapper must return, bitwise, what `score.compare_points`
returns on the samples posed by `se3.transform_points` and
`se3.rotate_vectors` (what `pso.score_particles` ran before K6), under
each lookup rule ("take", "mxu" "image", "mxu" "patch") with and without
the sub-pixel combine and the sample mask, for a single object, a library
with an image per object and a library sharing one image; and it must
count no launch. Without a card the launch's arguments are recorded: a
sliced library read where it lies, the images' and rows' strides, the
rule, the gates in the C function's order. On the card (cases marked `cuda`, skipped without a
device) K6 is held against the plain version at the main path's call
shapes:

- `counted` and `coverage` exact: every count is an integer in FP32, each
  classification the same comparisons on the same rounded values, and
  coverage one division of two of them;
- `support` within 1e-5 of max(|support|, 1), and `fitness` within 1e-6:
  the support is one sum of up to N terms, which the kernel adds in
  another order than ATen's reduction (thread by thread, then a fixed
  tree), and the fitness divides it by an exact count;
- a repeated call bitwise equal, and each object launched alone bitwise
  the library's launch: the order of each particle's sum is set by N
  alone.

This file imports neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_project_compare.py
"""
import math

import pytest
import torch

from icra20_hand_object_pose_tpu_torch.ops import knn_cuda, score
from icra20_hand_object_pose_tpu_torch.utils import se3

SCALE = torch.tensor([0.04, 0.03, 0.05])
GATES = dict(depth_tau=0.01, wrong_side_penalty=2.0, occlusion_margin=0.005,
             invalid_penalty=0.3, ghost_dilate=1, mask_count_floor=0.5)


def _camera(H, W):
    f = W * 570.0 / 640.0
    return dict(fx=f, fy=f, cx=W / 2.0, cy=H / 2.0, height=H, width=W)


def _scene(O, N, H, W, *, shared=False, seed=0):
    """O ellipsoids of object size near 0.5 m, each its N surface samples
    and outward normals (object frame) and its pose; an observed depth
    image per object (one for all with `shared`: object 0's, every object
    posed as object 0) ray-cast from the truth, with a floor behind it, no
    return above the horizon, 3% dropout and a few neutral pixels; the hand
    a block in front of each object's right half."""
    g = torch.Generator().manual_seed(seed)
    u = torch.nn.functional.normalize(torch.randn(O, N, 3, generator=g), dim=-1)
    scale = SCALE * (1.0 + 0.2 * torch.rand(O, 1, 3, generator=g))
    pts, nrm = u * scale, torch.nn.functional.normalize(u / scale, dim=-1)
    truth = se3.se3_exp(torch.cat([torch.randn(O, 3, generator=g) * 0.4,
                                   torch.zeros(O, 3)], -1))
    truth[:, :3, 3] = torch.stack([0.02 * torch.randn(O, generator=g),
                                   0.02 * torch.randn(O, generator=g),
                                   0.5 + 0.05 * torch.rand(O, generator=g)], -1)
    if shared:                  # every object where the one image shows object 0
        truth[:] = truth[0]
    cam = _camera(H, W)
    v, uu = torch.meshgrid(torch.arange(H, dtype=torch.float32),
                           torch.arange(W, dtype=torch.float32), indexing="ij")
    d = torch.stack([(uu - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                     torch.ones_like(uu)], -1)                   # [H,W,3] rays
    Oi = 1 if shared else O
    depth = torch.zeros(Oi, H, W)
    hand = torch.full((Oi, H, W), float("inf"))
    for o in range(Oi):
        R, c = truth[o, :3, :3], truth[o, :3, 3]
        dl = (d @ R) / scale[o, 0]                               # rays in the object frame
        cl = (c @ R) / scale[o, 0]
        A = (dl * dl).sum(-1)
        B = -2.0 * (dl * cl).sum(-1)
        C = (cl * cl).sum() - 1.0
        disc = B * B - 4.0 * A * C
        t = (-B - torch.sqrt(torch.clamp(disc, min=0.0))) / (2.0 * A)
        floor = torch.where(v > H * 0.4, torch.full_like(v, 0.7), torch.zeros_like(v))
        depth[o] = torch.where(disc > 0, t, floor)
        uc = int(round(float(c[0] / c[2]) * cam["fx"] + cam["cx"]))
        vc = int(round(float(c[1] / c[2]) * cam["fy"] + cam["cy"]))
        hand[o, max(vc - H // 10, 0):vc + H // 10, uc:uc + W // 8] = float(c[2]) - 0.06
    valid = (depth > 0) & (torch.rand(Oi, H, W, generator=g) > 0.03)
    depth = torch.where(valid, depth, 0.0)
    neutral = valid & (torch.rand(Oi, H, W, generator=g) < 0.02)
    return dict(pts=pts, nrm=nrm, truth=truth, depth=depth, valid=valid, hand=hand,
                enc=score.encode_observed(depth, valid, 1, neutral=neutral), cam=cam)


def _poses(truth, P, *, rot, trans, seed):
    """P poses per object about its truth (particle 0 the truth): random
    twists of `rot` rad and `trans` m, the last particle behind the camera
    and the one before it off the image."""
    O = truth.shape[0]
    g = torch.Generator().manual_seed(seed)
    xi = torch.cat([torch.randn(O, P, 3, generator=g) * rot,
                    torch.randn(O, P, 3, generator=g) * trans], -1).to(truth.device)
    xi[:, 0] = 0.0
    poses = se3.compose(truth[:, None], se3.se3_exp(xi))
    if P > 2:
        poses[:, -1, 2, 3] = -0.5
        poses[:, -2, 0, 3] += 1.0
    return poses


def _call(sc, rule, subpixel, masked, form, P, *, seed=0, patch=6, rot=0.05,
          trans=0.005, exempt=False):
    """The arguments of one scoring call: (poses, pts, nrm, observed, valid,
    hand, kw) for a single object ("single": [P,4,4], [N,3], [H,W]) or a
    library ("library": an image per object; "shared": one [1,H,W] for
    all), under `rule` ("take", "image" or "patch")."""
    O, N = sc["pts"].shape[:2]
    H, W = sc["cam"]["height"], sc["cam"]["width"]
    g = torch.Generator().manual_seed(seed + 1)
    poses = _poses(sc["truth"], P, rot=rot, trans=trans, seed=seed)
    pts, nrm = sc["pts"], sc["nrm"]
    images = [sc[k] for k in ("depth", "valid", "hand", "enc")]
    mask = (torch.rand(O, N, generator=g) > 0.2).to(pts.device) if masked else None
    ref = se3.transform_points(sc["truth"], pts)                 # the patches' origins
    zr = torch.clamp(ref[..., 2], min=1e-6)
    pu0 = torch.clamp(torch.round(ref[..., 0] / zr * sc["cam"]["fx"] + sc["cam"]["cx"]
                                  ).to(torch.int64) - patch // 2, 0, W - patch)
    pv0 = torch.clamp(torch.round(ref[..., 1] / zr * sc["cam"]["fy"] + sc["cam"]["cy"]
                                  ).to(torch.int64) - patch // 2, 0, H - patch)
    if form == "single":
        poses, pts, nrm, pv0, pu0 = poses[0], pts[0], nrm[0], pv0[0], pu0[0]
        images = [t[0] for t in images]
        mask = None if mask is None else mask[0]
    depth, valid, hand, enc = images
    kw = dict(sc["cam"], **GATES, subpixel=subpixel, sample_mask=mask,
              neutral_cov_exempt=exempt)
    if rule == "take":
        kw["observed_enc"] = enc
    elif rule == "image":
        kw["mxu_tables"] = ("image", enc, score.hand_table(hand))
    else:
        kw["mxu_tables"] = ("patch", enc, score.hand_table(hand), pv0, pu0, patch)
    return poses, pts, nrm, depth, valid, hand, kw


def _stepwise(poses, pts, nrm, depth, valid, hand, kw):
    """What `pso.score_particles` ran before K6: se3's posing, then
    `compare_points`."""
    if poses.dim() == 4:
        pts, nrm = pts[:, None], nrm[:, None]
    return score.compare_points(se3.transform_points(poses, pts),
                                se3.rotate_vectors(poses, nrm), depth, valid, hand, **kw)


@pytest.fixture(scope="module")
def cpu_scenes():
    return {shared: _scene(3, 60, 48, 64, shared=shared, seed=4) for shared in (False, True)}


@pytest.mark.parametrize("form", ["single", "library", "shared"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("subpixel", [False, True])
@pytest.mark.parametrize("rule", ["take", "image", "patch"])
def test_plain_is_compare_points(cpu_scenes, rule, subpixel, masked, form):
    """Bitwise `compare_points` on the posed samples, no launch counted; the
    calls hold samples that count, match, miss and are culled."""
    args = _call(cpu_scenes[form == "shared"], rule, subpixel, masked, form, 7,
                 exempt=masked)
    want = _stepwise(*args)
    fn = knn_cuda.project_compare_batched
    before = knn_cuda.launch_counts()[fn.__name__]
    got = fn(*args[:6], **args[6])
    assert knn_cuda.launch_counts()[fn.__name__] == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    lead = args[0].shape[:-2]
    assert got.fitness.shape == lead
    assert bool((got.counted[..., 0] > 0).all())               # the truth counts
    assert bool((got.counted[..., -1] == 0).all())             # behind the camera
    assert bool((got.coverage[..., 0] > 0).all())


@pytest.mark.parametrize("rule", ["take", "image", "patch"])
def test_launch_arguments(monkeypatch, rule):
    """What the wrapper hands the kernel, recorded without a card: a
    library's sliced samples and mask read where they lie (their rows'
    strides, no copy), an image per object (every 4 particles), a hand
    image for all, and the rule, sizes and gates under the C function's names;
    the launch counted by (P, N, H, W, rule, subpixel)."""
    import collections

    from icra20_hand_object_pose_tpu_torch.utils import profiling

    got = []
    monkeypatch.setattr(knn_cuda, "_route", lambda *a, **k: True)
    monkeypatch.setattr(knn_cuda, "_call", lambda kernel, device, values: got.append(
        dict(zip((name for name, _ in kernel.args), values))))
    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    O, P, Nr, N, H, W = 3, 4, 16, 10, 6, 5
    pts, nrm = torch.zeros(O, Nr, 3), torch.zeros(O, Nr, 3)
    mask = torch.ones(O, Nr, dtype=torch.bool)
    enc, hand = torch.zeros(O, H, W), torch.zeros(1, H, W)
    kw = dict(fx=1.0, fy=2.0, cx=3.0, cy=4.0, height=H, width=W, depth_tau=0.004,
              subpixel=True, sample_mask=mask[:, :N], neutral_cov_exempt=True)
    if rule == "take":
        kw["observed_enc"] = enc
    else:
        kw["mxu_tables"] = ("image", enc, hand)
        if rule == "patch":
            kw["mxu_tables"] = ("patch", enc, hand, torch.zeros(O, N, dtype=torch.int64),
                                torch.ones(O, N, dtype=torch.int64), 3)
    knn_cuda.project_compare_batched(torch.zeros(O, P, 4, 4), pts[:, :N], nrm[:, :N], enc,
                                     enc > 0, hand, **kw)
    (args,) = got
    assert args["pts"] == pts.data_ptr() and args["nrm"] == nrm.data_ptr()
    assert args["mask"] == mask.data_ptr() and (args["pv0"] is None) == (rule != "patch")
    ints = ("obj_stride", "mask_stride", "rows", "N", "H", "W", "rule", "subpixel",
            "pts_div", "img_div", "hand_div", "mask_div", "patch_div", "size", "exempt")
    assert tuple(args[k] for k in ints) == (
        3 * Nr, Nr, O * P, N, H, W, knn_cuda.PC_RULES[rule], 1, P, P, O * P, P,
        P if rule == "patch" else O * P, 3 if rule == "patch" else 0, 1)
    floats = ("fx", "fy", "cx", "cy", "tau", "inv_tau", "edge_tau", "pen", "inv_pen",
              "margin", "count_floor")
    f32 = [float(torch.tensor(v, dtype=torch.float32)) for v in
           (1.0, 2.0, 3.0, 4.0, 0.004, 1.0 / 0.004, 0.012, 2.0, 0.3, 0.005, 0.5)]
    assert [float(torch.tensor(args[k], dtype=torch.float32)) for k in floats] == f32
    assert knn_cuda.launch_counts()["project_compare_batched"][1] == {
        (O * P, N, H, W, rule, True): 1}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# (O, P, N, H, W, rule, subpixel, masked, form, rot, trans): the main path's
# calls. Tracked scan and explorer (coarse tier, 120 x 160, "mxu" image);
# the init prescreen (4096 orientations, "take"); the polish's candidates
# (VGA, "take", sub-pixel, self-occlusion mask); the finisher (VGA, "mxu"
# patch of 16, sub-pixel, mask); a sweep of 8 at both tiers, an image per
# object; and ragged cases (N no block size divides, a shared image)
CUDA_CASES = [
    (1, 512, 512, 120, 160, "image", False, False, "library", 0.05, 0.01),
    (1, 32, 512, 120, 160, "image", False, False, "library", 0.3, 0.02),
    (1, 4096, 512, 120, 160, "take", False, False, "library", 3.0, 0.01),
    (1, 18, 2048, 480, 640, "take", True, True, "library", 0.02, 0.003),
    (1, 512, 2048, 480, 640, "patch", True, True, "library", 0.01, 0.002),
    (8, 512, 512, 120, 160, "image", False, True, "library", 0.05, 0.01),
    (8, 512, 2048, 480, 640, "patch", True, True, "library", 0.01, 0.002),
    (3, 5, 777, 120, 160, "take", True, False, "shared", 0.05, 0.01),
    (2, 9, 37, 48, 64, "image", True, True, "shared", 0.05, 0.01),
    (1, 7, 300, 48, 64, "patch", False, False, "single", 0.05, 0.01),
]


def _agree(got, want):
    assert torch.equal(got.counted, want.counted)
    assert torch.equal(got.coverage, want.coverage)
    assert bool(((got.support - want.support).abs()
                 <= 1e-5 * want.support.abs().clamp(min=1.0)).all())
    assert (got.fitness - want.fitness).abs().max().item() <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("O,P,N,H,W,rule,subpixel,masked,form,rot,trans", CUDA_CASES)
def test_cuda_project_compare_matches_plain(cuda_device, O, P, N, H, W, rule, subpixel,
                                            masked, form, rot, trans):
    sc = _scene(O, N, H, W, shared=form == "shared", seed=N + P)
    sc = {k: v.to(cuda_device) if torch.is_tensor(v) else v for k, v in sc.items()}
    args = _call(sc, rule, subpixel, masked, form, P, seed=P, patch=16, rot=rot,
                 trans=trans, exempt=masked)
    fn = knn_cuda.project_compare_batched
    before = knn_cuda.launch_counts()[fn.__name__][0]
    got = fn(*args[:6], **args[6])
    want = knn_cuda.project_compare_plain(*args[:6], **args[6])
    torch.cuda.synchronize()
    launches, shapes = knn_cuda.launch_counts()[fn.__name__]
    assert launches == before + 1
    assert shapes[(math.prod(args[0].shape[:-2]), N, H, W, rule, subpixel)] >= 1
    assert bool((want.counted > 0).any()) and bool((want.support > 0).any())
    _agree(got, want)
    again = fn(*args[:6], **args[6])
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if O > 1:
        poses, pts, nrm, depth, valid, hand, kw = args
        for o in range(O):
            img = slice(o, o + 1) if depth.shape[0] == O else slice(0, 1)
            one_kw = dict(kw)
            if kw["sample_mask"] is not None:
                one_kw["sample_mask"] = kw["sample_mask"][o:o + 1]
            if "mxu_tables" in kw:
                t = kw["mxu_tables"]
                one_kw["mxu_tables"] = (t[0], t[1][img], t[2][img]) + (
                    (t[3][o:o + 1], t[4][o:o + 1], t[5]) if t[0] == "patch" else ())
            else:
                one_kw["observed_enc"] = kw["observed_enc"][img]
            alone = fn(poses[o:o + 1], pts[o:o + 1], nrm[o:o + 1], depth[img], valid[img],
                       hand[img], **one_kw)
            assert all(torch.equal(a[0], b[o]) for a, b in zip(alone, got))
