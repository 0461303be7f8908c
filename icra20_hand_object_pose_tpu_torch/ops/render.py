"""Depth rendering (counterpart of ops/render.py): the point splat of the
hot path and the exact triangle raster that makes synthetic frames.

`splat_depth`: scatter-min z-buffering of surface samples with a square
footprint: one radius-0 `scatter_reduce(amin)` into an r-padded grid
(out-of-range points go to a dump slot at hp*wp), then a separable
(2r+1)^2 min-pool over the padded grid with VALID windows.

`raster_depth`: perspective-correct triangle rasterization, O(F*H*W): a
loop over chunks of faces, each half-plane-testing a [C,H,W] block and
folding it into a min z-buffer. Generator-grade, not inner-loop grade.

Convention: +z forward; depth in meters; empty pixels are +inf.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# faces per step of the raster: one [64,480,640] FP32 block is 79 MB
_RASTER_CHUNK = 64


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


def raster_depth(
    vertices_cam: torch.Tensor,  # [V,3] camera-frame vertices
    faces: torch.Tensor,         # [F,3] integer vertex indices
    *,
    fx: float, fy: float, cx: float, cy: float,
    height: int, width: int,
) -> torch.Tensor:
    """Exact triangle rasterization -> depth [H,W], +inf where empty.

    Barycentric edge functions at pixel centres, 1/z interpolated linearly
    in the image (perspective-correct depth); a pixel is inside where all
    three barycentrics are >= 0. Faces with a vertex behind the camera are
    culled. The arithmetic keeps the reference's order (plain elementwise
    ops, no matmul), so interior depths agree to rounding and only edge
    pixels can flip."""
    dev, dt = vertices_cam.device, vertices_cam.dtype
    inf = float("inf")
    zbuf = torch.full((height, width), inf, dtype=dt, device=dev)
    if faces.shape[0] == 0:
        return zbuf
    faces = faces.to(torch.int64)
    z = vertices_cam[:, 2]
    safe_z = torch.clamp(z, min=1e-6)
    u = vertices_cam[:, 0] / safe_z * fx + cx
    v = vertices_cam[:, 1] / safe_z * fy + cy
    inv_z = 1.0 / safe_z
    tri_u, tri_v, tri_iz = u[faces], v[faces], inv_z[faces]      # [F,3]
    tri_ok = (z > 1e-6)[faces].all(dim=-1)                       # [F]
    px = torch.arange(width, dtype=dt, device=dev).expand(height, width)
    py = torch.arange(height, dtype=dt, device=dev)[:, None].expand(height, width)
    for s in range(0, faces.shape[0], _RASTER_CHUNK):
        c = slice(s, s + _RASTER_CHUNK)
        tu = tri_u[c, :, None, None]                             # [C,3,1,1]
        tv = tri_v[c, :, None, None]
        tiz = tri_iz[c, :, None, None]
        ok = tri_ok[c, None, None]
        # edge functions: twice the signed area terms
        d = ((tv[:, 1] - tv[:, 2]) * (tu[:, 0] - tu[:, 2])
             + (tu[:, 2] - tu[:, 1]) * (tv[:, 0] - tv[:, 2]))    # [C,1,1]
        d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        l0 = ((tv[:, 1] - tv[:, 2]) * (px - tu[:, 2])
              + (tu[:, 2] - tu[:, 1]) * (py - tv[:, 2])) / d     # [C,H,W]
        l1 = ((tv[:, 2] - tv[:, 0]) * (px - tu[:, 2])
              + (tu[:, 0] - tu[:, 2]) * (py - tv[:, 2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok
        iz = l0 * tiz[:, 0] + l1 * tiz[:, 1] + l2 * tiz[:, 2]
        zpix = torch.where(inside & (iz > 1e-9),
                           1.0 / torch.clamp(iz, min=1e-9), inf)
        zbuf = torch.minimum(zbuf, torch.amin(zpix, dim=0))
    return zbuf
