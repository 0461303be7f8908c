"""Depth-frame preprocessing (counterpart of ops/preprocess.py).

Backprojection, grid normals, validity masks and the fixed-size scene
subsample, as plain tensor code on the frame's device. The subsample's
random priorities and output permutation come from `gen` (a
torch.Generator, or injected draws).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..utils import rng
from . import camera


class SceneCloud(NamedTuple):
    """Fixed-size scene observation.

    points:  [Ns,3] camera-frame points (padding at 1e6)
    normals: [Ns,3] unit normals (padding 0)
    weights: [Ns]   1.0 valid / 0.0 padding
    depth, valid:           [h,w] render-factor-downsampled tier
    depth_full, valid_full: [H,W] full-resolution tier
    neutral, neutral_full:  measured-in-range pixels excluded from object
                            evidence (hand drop, speckle): no-evidence
                            class for scoring
    """
    points: torch.Tensor
    normals: torch.Tensor
    weights: torch.Tensor
    depth: torch.Tensor
    valid: torch.Tensor
    depth_full: torch.Tensor
    valid_full: torch.Tensor
    neutral: torch.Tensor
    neutral_full: torch.Tensor


def speckle_mask(
    depth: torch.Tensor, valid: torch.Tensor, *, tau: float, min_neighbors: int
) -> torch.Tensor:
    """A valid pixel survives only if >= min_neighbors of its 8 neighbours
    are valid and within `tau` meters of it."""
    d = torch.where(valid, depth, torch.full_like(depth, 1e9))
    dp = F.pad(d[None, None], (1, 1, 1, 1), value=1e9)[0, 0]
    H, W = depth.shape
    count = torch.zeros(depth.shape, dtype=torch.int32, device=depth.device)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            n = dp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            count = count + (torch.abs(n - d) < tau).to(torch.int32)
    return valid & (count >= min_neighbors)


def downsample_depth(depth: torch.Tensor, valid: torch.Tensor,
                     factor: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Min-pool depth by `factor` (foreground-preserving), propagate validity."""
    if factor == 1:
        return depth, valid
    H, W = depth.shape
    Hc, Wc = H // factor, W // factor
    d = torch.where(valid, depth, torch.full_like(depth, float("inf")))
    d = d[: Hc * factor, : Wc * factor].reshape(Hc, factor, Wc, factor)
    dmin = torch.amin(d, dim=(1, 3))
    v = torch.isfinite(dmin)
    return torch.where(v, dmin, 0.0), v


def downsample_mask_any(mask: torch.Tensor, factor: int) -> torch.Tensor:
    """Any-pool a bool mask by `factor`."""
    if factor == 1:
        return mask
    H, W = mask.shape
    Hc, Wc = H // factor, W // factor
    m = mask[: Hc * factor, : Wc * factor].reshape(Hc, factor, Wc, factor)
    return torch.any(torch.any(m, dim=3), dim=1)


def subsample_cloud(
    gen,
    points: torch.Tensor,
    normals: torch.Tensor,
    valid: torch.Tensor,
    n_out: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Random fixed-size subsample of valid grid points, 2-D lattice-
    stratified: one random-priority argmin per pixel-residue bucket, output
    slots randomly permuted (see the JAX module for the rationale).

    points/normals [H,W,3], valid [H,W] -> ([n,3], [n,3], weights [n]).
    Draws, in order: priorities uniform [H*W], permutation of n_out.
    """
    H, W = valid.shape
    flat_p = points.reshape(-1, 3)
    flat_n = normals.reshape(-1, 3)
    flat_v = valid.reshape(-1)
    hw = H * W
    target = max(1.0, (n_out * W / max(H, 1)) ** 0.5)
    gw = min((d for d in range(1, n_out + 1) if n_out % d == 0),
             key=lambda d: abs(d - target))
    gh = n_out // gw
    Hq, Wq = -(-H // gh), -(-W // gw)
    pri = rng.uniform(gen, (hw,))
    perm = rng.permutation(gen, n_out)
    pri = torch.where(flat_v, pri, 2.0)  # invalid last within each bucket
    p2 = F.pad(pri.reshape(1, 1, H, W), (0, Wq * gw - W, 0, Hq * gh - H),
               value=2.0)[0, 0]
    pt = p2.reshape(Hq, gh, Wq, gw).permute(1, 3, 0, 2).reshape(n_out, Hq * Wq)
    k = torch.argmin(pt, dim=1)[perm]                          # [n_out]
    pt_min = torch.amin(pt, dim=1)[perm]
    c = perm
    y = (k // Wq) * gh + c // gw
    x = (k % Wq) * gw + c % gw
    order = torch.clamp(y * W + x, max=hw - 1)
    # weight gates on the winning PRIORITY (< 1.5 iff a valid pixel won)
    w = (pt_min < 1.5).to(points.dtype)
    p = flat_p[order]
    n = flat_n[order]
    p = torch.where(w[:, None] > 0, p, 1e6)
    n = torch.where(w[:, None] > 0, n, 0.0)
    return p, n, w


def preprocess_frame(
    gen,
    depth_m: torch.Tensor,
    *,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    depth_min: float,
    depth_max: float,
    n_points: int,
    render_factor: int = 1,
    extra_invalid: torch.Tensor | None = None,
    outlier_tau: float = 0.0,
    outlier_min_neighbors: int = 2,
) -> SceneCloud:
    """depth (meters, [H,W]) -> SceneCloud. `extra_invalid` [H,W] bool marks
    pixels to drop (the rendered hand mask); `outlier_tau` > 0 enables the
    grid speckle filter."""
    in_rng = (depth_m > depth_min) & (depth_m < depth_max) & torch.isfinite(depth_m)
    valid = in_rng
    if extra_invalid is not None:
        valid = valid & (~extra_invalid)
    if outlier_tau > 0.0:
        valid = speckle_mask(depth_m, valid, tau=outlier_tau,
                             min_neighbors=outlier_min_neighbors)
    neutral_full = in_rng & (~valid)
    depth_c = torch.where(valid, depth_m, 0.0)
    cloud = camera.backproject(depth_c, fx, fy, cx, cy)
    normals = camera.grid_normals(cloud, valid)
    nvalid = valid & (torch.sum(normals * normals, dim=-1) > 0.5)
    pts, nrm, w = subsample_cloud(gen, cloud, normals, nvalid, n_points)
    d_lo, v_lo = downsample_depth(depth_c, valid, render_factor)
    n_lo = downsample_mask_any(neutral_full, render_factor)
    return SceneCloud(points=pts, normals=nrm, weights=w, depth=d_lo,
                      valid=v_lo, depth_full=depth_c, valid_full=valid,
                      neutral=n_lo, neutral_full=neutral_full)
