"""Depth frames: an exact triangle raster and a depth-sensor model, on the
device, in plain PyTorch. A frozen copy of the repo's synthetic-sequence
arithmetic (barycentric edge functions at pixel centres, 1/z interpolated
in the image; lateral jitter, axial noise growing with (z / z_ref)^2,
quantisation, dropout), with the sensor's draws taken from a seeded
torch.Generator on the device. Imports nothing of the program."""
from __future__ import annotations

import numpy as np
import torch

CHUNK = 64  # faces per raster step


def raster_depth(vertices: torch.Tensor, faces: torch.Tensor, cam: dict) -> torch.Tensor:
    """Exact raster of camera-frame triangles -> depth [H,W], +inf where
    empty. Only the box that the projected vertices cover is rastered; no
    face reaches outside it."""
    H, W = int(cam["height"]), int(cam["width"])
    dev, dt = vertices.device, vertices.dtype
    inf = float("inf")
    zbuf = torch.full((H, W), inf, dtype=dt, device=dev)
    z = vertices[:, 2]
    safe_z = torch.clamp(z, min=1e-6)
    u = vertices[:, 0] / safe_z * cam["fx"] + cam["cx"]
    v = vertices[:, 1] / safe_z * cam["fy"] + cam["cy"]
    inv_z = 1.0 / safe_z
    front = z > 1e-6
    if not bool(front.any()):
        return zbuf
    box = torch.stack([u[front].min(), u[front].max(), v[front].min(),
                       v[front].max()]).cpu().numpy()
    u0, u1 = max(0, int(np.floor(box[0]))), min(W, int(np.ceil(box[1])) + 1)
    v0, v1 = max(0, int(np.floor(box[2]))), min(H, int(np.ceil(box[3])) + 1)
    if u0 >= u1 or v0 >= v1:
        return zbuf
    faces = faces.to(torch.int64)
    tri_u, tri_v, tri_iz = u[faces], v[faces], inv_z[faces]
    tri_ok = front[faces].all(dim=-1)
    px = torch.arange(u0, u1, dtype=dt, device=dev).expand(v1 - v0, u1 - u0)
    py = torch.arange(v0, v1, dtype=dt, device=dev)[:, None].expand(v1 - v0, u1 - u0)
    crop = torch.full((v1 - v0, u1 - u0), inf, dtype=dt, device=dev)
    for s in range(0, faces.shape[0], CHUNK):
        c = slice(s, s + CHUNK)
        tu, tv = tri_u[c, :, None, None], tri_v[c, :, None, None]
        tiz, ok = tri_iz[c, :, None, None], tri_ok[c, None, None]
        d = ((tv[:, 1] - tv[:, 2]) * (tu[:, 0] - tu[:, 2])
             + (tu[:, 2] - tu[:, 1]) * (tv[:, 0] - tv[:, 2]))
        d = torch.where(torch.abs(d) < 1e-12, 1e-12, d)
        l0 = ((tv[:, 1] - tv[:, 2]) * (px - tu[:, 2])
              + (tu[:, 2] - tu[:, 1]) * (py - tv[:, 2])) / d
        l1 = ((tv[:, 2] - tv[:, 0]) * (px - tu[:, 2])
              + (tu[:, 0] - tu[:, 2]) * (py - tv[:, 2])) / d
        l2 = 1.0 - l0 - l1
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok
        iz = l0 * tiz[:, 0] + l1 * tiz[:, 1] + l2 * tiz[:, 2]
        zpix = torch.where(inside & (iz > 1e-9), 1.0 / torch.clamp(iz, min=1e-9), inf)
        crop = torch.minimum(crop, torch.amin(zpix, dim=0))
    zbuf[v0:v1, u0:u1] = crop
    return zbuf


def sensor_model(depth: torch.Tensor, sensor: dict, gen: torch.Generator) -> torch.Tensor:
    """A clean render (+inf or 0 = no return) -> sensor depth (0 = no
    return): lateral edge jitter, axial noise, quantisation, dropout, in
    that order."""
    d = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    H, W = d.shape
    dev = d.device
    if sensor["edge_sigma_px"] > 0:
        dv = torch.round(torch.randn((H, W), generator=gen, device=dev)
                         * sensor["edge_sigma_px"]).long()
        du = torch.round(torch.randn((H, W), generator=gen, device=dev)
                         * sensor["edge_sigma_px"]).long()
        vv = torch.arange(H, device=dev)[:, None]
        uu = torch.arange(W, device=dev)[None, :]
        d = d[torch.clamp(vv + dv, 0, H - 1), torch.clamp(uu + du, 0, W - 1)]
    valid = d > 0
    if sensor["noise_sigma"] > 0:
        sig = sensor["noise_sigma"]
        if sensor["depth_sq_noise"]:
            sig = sig * torch.square(torch.clamp(d, min=0.0) / sensor["z_ref"])
        d = torch.where(valid, d + torch.randn((H, W), generator=gen, device=dev) * sig,
                        torch.zeros_like(d))
    if sensor["quantize"] > 0:
        q = sensor["quantize"]
        d = torch.where(valid, torch.round(d / q) * q, torch.zeros_like(d))
    if sensor["dropout"] > 0:
        drop = torch.rand((H, W), generator=gen, device=dev) < sensor["dropout"]
        d = torch.where(drop, torch.zeros_like(d), d)
    return d
