"""Camera projection / backprojection (counterpart of ops/camera.py).

Camera convention: +z forward, +x right, +y down (OpenCV); images [H,W].
"""
from __future__ import annotations

import torch


def backproject(depth: torch.Tensor, fx, fy, cx, cy) -> torch.Tensor:
    """Depth image [H,W] (meters) -> organized cloud [H,W,3] in camera frame.
    Invalid (<=0) depths produce z=0 points; mask separately."""
    H, W = depth.shape
    u = torch.arange(W, dtype=torch.float32, device=depth.device)[None, :].expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=depth.device)[:, None].expand(H, W)
    x = (u - cx) / fx * depth
    y = (v - cy) / fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project(points: torch.Tensor, fx, fy, cx, cy) -> tuple[torch.Tensor, torch.Tensor]:
    """Points [..,N,3] camera frame -> (pixel uv [..,N,2], depth z [..,N])."""
    z = points[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = points[..., 0] / safe_z * fx + cx
    v = points[..., 1] / safe_z * fy + cy
    return torch.stack([u, v], dim=-1), z


def grid_normals(cloud: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Surface normals on an organized cloud via image-grid central
    differences (wrapping at the border, as `jnp.roll` does), oriented
    toward the camera. cloud [H,W,3], valid [H,W] bool -> normals [H,W,3]
    (zero where invalid or degenerate)."""
    def shift(a, dy, dx):
        return torch.roll(a, shifts=(dy, dx), dims=(0, 1))

    vx0, vx1 = shift(cloud, 0, 1), shift(cloud, 0, -1)
    vy0, vy1 = shift(cloud, 1, 0), shift(cloud, -1, 0)
    mx = shift(valid, 0, 1) & shift(valid, 0, -1)
    my = shift(valid, 1, 0) & shift(valid, -1, 0)
    dx = vx1 - vx0
    dy = vy1 - vy0
    n = torch.linalg.cross(dx, dy)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    ok = (norm[..., 0] > 1e-9) & mx & my & valid
    n = n / torch.clamp(norm, min=1e-9)
    flip = torch.sum(n * cloud, dim=-1, keepdim=True) > 0
    n = torch.where(flip, -n, n)
    return torch.where(ok[..., None], n, 0.0)
