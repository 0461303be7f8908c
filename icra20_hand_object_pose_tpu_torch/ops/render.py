"""Point-splat depth rendering (counterpart of ops/render.py's
`splat_depth` and `splat_depth_batched`).

Scatter-min z-buffering of surface samples with a square footprint: one
radius-0 `scatter_reduce(amin)` into an r-padded grid (out-of-range points
go to a dump slot at hp*wp), then a separable (2r+1)^2 min-pool over the
padded grid with VALID windows. Empty pixels are +inf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def splat_depth_batched(
    points_cam: torch.Tensor,  # [P,N,3] camera-frame surface samples
    weights: torch.Tensor,     # [N] or [P,N]; 0 disables a point
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
    radius: int = 1,
) -> torch.Tensor:
    """[P] point-splat depth images [P,H,W]; +inf where nothing rendered."""
    P = points_cam.shape[0]
    if weights.dim() == 1:
        weights = weights.expand(points_cam.shape[:2])
    z = points_cam[..., 2]
    valid = (z > 1e-6) & (weights > 0)
    safe_z = torch.where(valid, z, 1.0)
    u = points_cam[..., 0] / safe_z * fx + cx
    v = points_cam[..., 1] / safe_z * fy + cy
    ui = torch.round(u).to(torch.int64)   # half to even, as jnp.round
    vi = torch.round(v).to(torch.int64)
    r = radius
    hp, wp = height + 2 * r, width + 2 * r
    inb = valid & (ui >= -r) & (ui < width + r) & (vi >= -r) & (vi < height + r)
    flat = torch.where(inb, (vi + r) * wp + (ui + r), hp * wp)
    zval = torch.where(valid, z, float("inf"))
    zbuf = torch.full((P, hp * wp + 1), float("inf"), dtype=points_cam.dtype,
                      device=points_cam.device)
    zbuf.scatter_reduce_(1, flat, zval, reduce="amin", include_self=True)
    img = zbuf[:, : hp * wp].reshape(P, 1, hp, wp)
    if r > 0:
        k = 2 * r + 1
        img = -F.max_pool2d(-img, kernel_size=(k, 1), stride=1)
        img = -F.max_pool2d(-img, kernel_size=(1, k), stride=1)
    return img[:, 0]


def splat_depth(
    points_cam: torch.Tensor,  # [N,3]
    weights: torch.Tensor,     # [N]
    **kwargs,
) -> torch.Tensor:
    """Point-splat depth image [H,W]; +inf where nothing rendered."""
    return splat_depth_batched(points_cam[None], weights[None], **kwargs)[0]
