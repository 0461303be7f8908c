"""Render-and-compare hypothesis scoring (counterpart of ops/score.py):
point mode (`compare_points`, with `encode_observed`, `pack_quad`,
`_bilinear_depth`, `_edge_aware_combine`) and pixel mode (`compare_depth`
on rendered depth images).

Fitness is higher-better: per visible model sample (or rendered pixel),
support where the observed depth agrees within tau, a wrong-side penalty
where it floats in front of a measured surface, a ghost penalty where it
lands on no-return pixels; hand-occluded samples are excluded. See the JAX
module's header for the full semantics, which are kept unchanged.

Image lookups are plain indexed gathers. The two lookup rules of the
reference are kept, chosen by `ScoreConfig.gather_mode`:

  - "take": flat gathers; the 2x2 bilinear cell comes from the _FAR-
    bordered quad table (`pack_quad`), and the hand image keeps +inf with
    a plain `d_hand < z - margin` occlusion test;
  - "mxu" (the default; a one-hot matrix product on the TPU): an
    out-of-range index, or in "patch" form an index outside the sample's
    reference patch, reads 0.0; the hand image carries _FAR instead of
    +inf and occludes only where `0 < d_hand < z - margin`. The values are
    exact here, where the TPU's double-bf16 split was good to ~3 um.

A library of O objects is scored in one pass: the samples then carry a
leading object axis ([O,P,N,3]) and each image argument is [O,H,W] (one
observation per object) or [1,H,W] (one shared by all); object o's samples
read image o. The [H,W] form is the single-object case.

On the card the point-mode scorer runs as kernel K6
(`knn_cuda.project_compare_batched`: the posing and `compare_points` in
one launch); `compare_points` is its plain version, which the CPU runs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class ScoreTerms(NamedTuple):
    fitness: torch.Tensor   # [...,] higher better
    coverage: torch.Tensor  # [...,] in [0,1]
    support: torch.Tensor   # [...,] sum of per-sample support
    counted: torch.Tensor   # [...,] samples with evidence


# invalid-pixel classes in the encoded observed image (encode_observed)
_FAR = 1e9       # no return, away from the silhouette -> ghost penalty
_NEAR = -1.0     # no return within ghost_dilate px of a return: no penalty
_NEUTRAL = -2.0  # measured in range but excluded from evidence


def _read(img: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """img.reshape(-1)[flat] for one image ([H,W], or [1,H,W] shared by
    every object); with [O,H,W], row o of flat ([O,...]) reads image o."""
    if img.dim() == 2 or img.shape[0] == 1:
        return img.reshape(-1)[flat]
    O = img.shape[0]
    return torch.gather(img.reshape(O, -1), 1, flat.reshape(O, -1)).reshape(flat.shape)


def encode_observed(
    observed: torch.Tensor,        # [H,W] depth, 0 invalid ([O,H,W]: per object)
    observed_valid: torch.Tensor,  # [H,W] bool
    ghost_dilate: int = 1,
    neutral: torch.Tensor | None = None,
) -> torch.Tensor:
    """Fold (depth, valid, near-silhouette band, neutral) into one image:
    valid pixels carry depth, no-return pixels _NEAR within `ghost_dilate`
    px of a valid return and _FAR beyond it, neutral pixels _NEUTRAL."""
    if ghost_dilate > 0:
        fill = torch.where(_near_return(observed_valid, ghost_dilate),
                           _NEAR, _FAR)
    else:
        fill = torch.full_like(observed, _FAR)
    if neutral is not None:
        fill = torch.where(neutral, _NEUTRAL, fill)
    return torch.where(observed_valid, observed, fill)


def _near_return(observed_valid: torch.Tensor, ghost_dilate: int) -> torch.Tensor:
    """[...,H,W] bool: within `ghost_dilate` px of a valid return (a
    SAME-padded (2d+1)^2 OR window)."""
    k = 2 * ghost_dilate + 1
    H, W = observed_valid.shape[-2:]
    near = F.max_pool2d(observed_valid.to(torch.float32).reshape(-1, 1, H, W),
                        kernel_size=k, stride=1, padding=ghost_dilate)
    return near.reshape(observed_valid.shape) > 0


def compare_depth(
    rendered: torch.Tensor,        # [...,H,W] hypothesis depth (+inf empty)
    observed: torch.Tensor,        # [H,W] observed depth (0 invalid)
    observed_valid: torch.Tensor,  # [H,W] bool
    hand_depth: torch.Tensor | None = None,  # [H,W] (+inf none)
    *,
    depth_tau: float = 0.01,
    wrong_side_penalty: float = 2.0,
    occlusion_margin: float = 0.005,
    invalid_penalty: float = 0.3,
    ghost_dilate: int = 1,
    observed_enc: torch.Tensor | None = None,
) -> ScoreTerms:
    """Score rendered depth image(s) against one observed frame, pixel by
    pixel; broadcasts over leading particle axes of `rendered`. Rendered
    pixels within `ghost_dilate` px of a valid return are not ghosts;
    `observed_enc` (encode_observed's output) carries that band
    precomputed. With [O,H,W] observations, `rendered` is [O,P,H,W]."""
    dt = rendered.dtype
    inf = float("inf")
    if observed.dim() == 3:
        # one observation per object (or one for all): beside the particle axis
        observed, observed_valid = observed[:, None], observed_valid[:, None]
        hand_depth = None if hand_depth is None else hand_depth[:, None]
        observed_enc = None if observed_enc is None else observed_enc[:, None]
    r_valid = torch.isfinite(rendered)
    if hand_depth is not None:
        visible = r_valid & ~(hand_depth < rendered - occlusion_margin)
    else:
        visible = r_valid

    obs = torch.where(observed_valid, observed, inf)
    diff = rendered - obs                 # inf - inf only where not counted
    absdiff = torch.abs(diff)

    counted_px = visible & observed_valid
    match = counted_px & (absdiff < depth_tau)
    wrong = counted_px & (diff < -depth_tau)
    if observed_enc is not None:
        not_near = observed_enc >= 0.5 * _FAR
    elif ghost_dilate > 0:
        not_near = ~_near_return(observed_valid, ghost_dilate)
    else:
        not_near = ~observed_valid
    ghost = visible & (~observed_valid) & not_near

    support_px = torch.where(match, 1.0 - absdiff / depth_tau, 0.0)
    axes = (-1, -2)
    support = torch.sum(support_px, dim=axes)
    n_wrong = torch.sum(wrong.to(dt), dim=axes)
    n_ghost = torch.sum(ghost.to(dt), dim=axes)
    n_counted = torch.sum(counted_px.to(dt), dim=axes) + n_ghost

    fitness = (support - wrong_side_penalty * n_wrong
               - invalid_penalty * n_ghost) / torch.clamp(n_counted, min=1.0)
    # renders with nothing visible must lose to anything real
    fitness = torch.where(n_counted > 0, fitness,
                          torch.full_like(fitness, -wrong_side_penalty))

    n_obs = torch.clamp(torch.sum(observed_valid.to(dt), dim=axes), min=1.0)
    coverage = torch.sum(match.to(dt), dim=axes) / n_obs
    return ScoreTerms(fitness=fitness, coverage=coverage, support=support,
                      counted=n_counted)


def pack_quad(enc: torch.Tensor) -> torch.Tensor:
    """[H,W] encoded image -> [(H+1)*(W+1), 4] per-cell 2x2 neighbourhoods
    with a _FAR border: row (v0+1)*(W+1)+(u0+1) holds enc at (v0,u0),
    (v0,u0+1), (v0+1,u0), (v0+1,u0+1). [O,H,W] -> [O,(H+1)*(W+1),4]."""
    ep = F.pad(enc, (1, 1, 1, 1), value=_FAR)
    q = torch.stack([ep[..., :-1, :-1], ep[..., :-1, 1:], ep[..., 1:, :-1],
                     ep[..., 1:, 1:]], dim=-1)
    return q.reshape(tuple(enc.shape[:-2]) + (-1, 4))


def _take_zero(img: torch.Tensor, vi: torch.Tensor, ui: torch.Tensor,
               patch: tuple | None = None) -> torch.Tensor:
    """img[vi, ui], reading 0.0 outside the image or, with patch =
    (pv0, pu0, size), outside each sample's [size,size] patch. img [H,W],
    or [O,H,W] with vi/ui [O,P,N] (patch origins then [O,1,N])."""
    H, W = img.shape[-2:]
    ok = (vi >= 0) & (vi < H) & (ui >= 0) & (ui < W)
    if patch is not None:
        pv0, pu0, size = patch
        lv, lu = vi - pv0, ui - pu0
        ok = ok & (lv >= 0) & (lv < size) & (lu >= 0) & (lu < size)
    flat = torch.where(ok, vi * W + ui, 0)
    return torch.where(ok, _read(img, flat), 0.0)


def _bilinear_depth(
    u: torch.Tensor, v: torch.Tensor, inb: torch.Tensor, enc: torch.Tensor,
    *, height: int, width: int, edge_tau: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-aware bilinear sample of an encoded observed image through the
    quad table ("take" rule). Returns (depth, valid, e_ref)."""
    packed = pack_quad(enc)
    u0 = torch.floor(u)
    v0 = torch.floor(v)
    base = torch.where(inb, (v0.long() + 1) * (width + 1) + (u0.long() + 1), 0)
    if packed.dim() == 2 or packed.shape[0] == 1:
        quad = packed.reshape(-1, 4)[base]                     # [...,N,4]
    else:
        O = packed.shape[0]
        quad = torch.gather(packed, 1, base.reshape(O, -1, 1).expand(-1, -1, 4)
                            ).reshape(tuple(base.shape) + (4,))
    return _edge_aware_combine(u - u0, v - v0, inb,
                               [quad[..., k] for k in range(4)], edge_tau)


def _edge_aware_combine(
    au: torch.Tensor, av: torch.Tensor, inb: torch.Tensor,
    corners: list,   # [d00, d01, d10, d11] encoded values
    edge_tau: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Edge-aware bilinear combination of the four 2x2 corner values:
    corners weigh in only if valid and within edge_tau of the nearest
    corner's depth; an invalid nearest corner makes the sample invalid."""
    d_corner, w_corner, m_corner = [], [], []
    for k, (dv, du) in enumerate(((0, 0), (0, 1), (1, 0), (1, 1))):
        d = corners[k]
        w = (au if du else 1.0 - au) * (av if dv else 1.0 - av)
        d_corner.append(d)
        w_corner.append(w)
        m_corner.append(inb & (d > 0.0) & (d < 0.5 * _FAR))
    near_u = au >= 0.5
    near_v = av >= 0.5
    sel = [(~near_u & ~near_v), (near_u & ~near_v),
           (~near_u & near_v), (near_u & near_v)]
    d_ref = sum(torch.where(s, d, 0.0) for s, d in zip(sel, d_corner))
    ref_ok = sum(torch.where(s, m.to(au.dtype), 0.0)
                 for s, m in zip(sel, m_corner)) > 0.5
    num = torch.zeros_like(au)
    den = torch.zeros_like(au)
    for d, w, m in zip(d_corner, w_corner, m_corner):
        wk = w * m * (torch.abs(d - d_ref) < edge_tau)
        num = num + wk * torch.where(m, d, 0.0)
        den = den + wk
    valid = ref_ok & (den > 1e-6)
    depth = torch.where(valid, num / torch.clamp(den, min=1e-6), 0.0)
    return depth, valid, d_ref


def hand_table(hand_depth: torch.Tensor) -> torch.Tensor:
    """Hand depth for the "mxu" rule: +inf (no hand) becomes _FAR."""
    return torch.where(torch.isfinite(hand_depth), hand_depth, _FAR)


def compare_points(
    pts_cam: torch.Tensor,         # [...,N,3] posed model surface samples
    normals_cam: torch.Tensor,     # [...,N,3] posed outward normals
    observed: torch.Tensor,        # [H,W] observed depth (0 invalid), or [O,H,W]
    observed_valid: torch.Tensor,  # [H,W] bool
    hand_depth: torch.Tensor | None = None,  # [H,W] (+inf none), or [O,H,W]
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    depth_tau: float = 0.01,
    wrong_side_penalty: float = 2.0,
    occlusion_margin: float = 0.005,
    invalid_penalty: float = 0.3,
    subpixel: bool = False,
    ghost_dilate: int = 1,
    observed_enc: torch.Tensor | None = None,
    mxu_tables: tuple | None = None,
    neutral_cov_exempt: bool = False,
    sample_mask: torch.Tensor | None = None,  # [N] bool, or [O,N]
    mask_count_floor: float = 0.5,
) -> ScoreTerms:
    """Point-wise render-and-compare: each posed sample looks up the
    observed depth at its projection and is classified like a rendered
    pixel; back-facing samples are culled.

    mxu_tables selects the "mxu" lookup rule (see the module docstring):
      ("image", enc, hand)                  full-image lookups;
      ("patch", enc, hand, pv0, pu0, size)  per-sample [size,size] patches
                                            at origins pv0/pu0 [N];
    enc is the encoded observed image, hand = hand_table(hand depth) or
    None. Without it the "take" rule applies.

    With [O,H,W] images (one per object, or [1,H,W] for all) pts_cam is
    [O,P,N,3]; sample_mask and the patch origins are then [O,N]."""
    if sample_mask is not None and sample_mask.dim() == 2:
        sample_mask = sample_mask[:, None]                      # [O,1,N]
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    in_front = z > 1e-6
    zs = torch.where(in_front, z, 1.0)
    u = x / zs * fx + cx
    v = y / zs * fy + cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    inb = in_front & (ui >= 0) & (ui < width) & (vi >= 0) & (vi < height)
    facing = torch.sum(normals_cam * pts_cam, dim=-1) < 0.0
    vis = inb & facing

    if mxu_tables is not None:
        if mxu_tables[0] == "patch":
            _, enc, hand, pv0, pu0, size = mxu_tables
            if pv0.dim() == 2:
                pv0, pu0 = pv0[:, None], pu0[:, None]          # [O,1,N]
            patch = (pv0, pu0, size)
        else:
            _, enc, hand = mxu_tables
            patch = None
        if subpixel:
            u0 = torch.floor(u)
            v0 = torch.floor(v)
            v0i, u0i = v0.long(), u0.long()
            corners = [_take_zero(enc, v0i + dv, u0i + du, patch)
                       for dv, du in ((0, 0), (0, 1), (1, 0), (1, 1))]
            d_obs, v_obs, e_ref = _edge_aware_combine(
                u - u0, v - v0, inb, corners, 3.0 * depth_tau)
        else:
            e_ref = _take_zero(enc, vi, ui, patch)
            v_obs = inb & (e_ref > 0.0) & (e_ref < 0.5 * _FAR)
            d_obs = e_ref
        if hand is not None:
            d_hand = _take_zero(hand, vi, ui, patch)
            vis = vis & ~((d_hand > 0.0) & (d_hand < z - occlusion_margin))
    else:
        if observed_enc is None:
            observed_enc = encode_observed(observed, observed_valid, ghost_dilate)
        flat = torch.where(inb, vi * width + ui, 0)
        if subpixel:
            d_obs, v_obs, e_ref = _bilinear_depth(
                u, v, inb, observed_enc,
                height=height, width=width, edge_tau=3.0 * depth_tau,
            )
        else:
            e_ref = _read(observed_enc, flat)
            v_obs = inb & (e_ref > 0.0) & (e_ref < 0.5 * _FAR)
            d_obs = e_ref
        if hand_depth is not None:
            d_hand = _read(hand_depth, flat)
            vis = vis & ~(d_hand < z - occlusion_margin)

    vis0 = vis
    if sample_mask is not None:
        vis = vis & sample_mask

    diff = z - torch.where(v_obs, d_obs, float("inf"))
    absdiff = torch.abs(diff)
    counted = vis & v_obs
    match = counted & (absdiff < depth_tau)
    wrong = counted & (diff < -depth_tau)
    ghost = vis & (e_ref >= 0.5 * _FAR)

    dt = pts_cam.dtype
    support = torch.sum(torch.where(match, 1.0 - absdiff / depth_tau, 0.0), dim=-1)
    n_wrong = torch.sum(wrong.to(dt), dim=-1)
    n_ghost = torch.sum(ghost.to(dt), dim=-1)
    n_counted = torch.sum(counted.to(dt), dim=-1) + n_ghost

    n_den = torch.clamp(n_counted, min=1.0)
    if sample_mask is not None:
        # denominator floor at a fraction of the UNMASKED counted set
        counted0 = vis0 & v_obs
        ghost0 = vis0 & (e_ref >= 0.5 * _FAR)
        n0 = (torch.sum(counted0.to(dt), dim=-1)
              + torch.sum(ghost0.to(dt), dim=-1))
        n_den = torch.maximum(n_den, mask_count_floor * n0)

    fitness = (support - wrong_side_penalty * n_wrong
               - invalid_penalty * n_ghost) / n_den
    fitness = torch.where(n_counted > 0, fitness,
                          torch.full_like(fitness, -wrong_side_penalty))

    n_vis = torch.sum(vis.to(dt), dim=-1)
    if neutral_cov_exempt:
        no_ev = vis & (e_ref < 0.5 * (_NEAR + _NEUTRAL))
        n_vis = n_vis - torch.sum(no_ev.to(dt), dim=-1)
    n_vis = torch.clamp(n_vis, min=1.0)
    if sample_mask is not None:
        n_vis = torch.maximum(
            n_vis, mask_count_floor * torch.sum(vis0.to(dt), dim=-1))
    coverage = torch.sum(match.to(dt), dim=-1) / n_vis
    return ScoreTerms(fitness=fitness, coverage=coverage, support=support,
                      counted=n_counted)
