"""Synthetic grasp frames without JAX (counterpart of datasets/synthetic.py's
`render_frame_fast`, `default_object_pose`, `hand_base_for_grasp` and the
numpy sensor model). The exact triangle raster (`render_frame`,
`generate_sequence`) is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models.hand import HandModel
from ..ops import render
from ..utils import meshio
from ..utils.config import CameraIntrinsics


@dataclass
class SensorModel:
    """Depth-sensor error model: lateral edge jitter, axial noise growing
    with (z/z_ref)^2, quantization, dropout (in that order)."""
    noise_sigma: float = 0.001   # meters at z_ref
    z_ref: float = 0.5           # meters; sigma reference range
    depth_sq_noise: bool = True  # sigma grows (z/z_ref)^2; False = flat
    quantize: float = 0.001      # meters; 0 disables (16-bit mm PNG LSB)
    edge_sigma_px: float = 0.5   # lateral jitter stddev in pixels
    dropout: float = 0.02


def apply_sensor_model(
    depth: np.ndarray, sm: SensorModel, rng: np.random.Generator
) -> np.ndarray:
    """Apply the SensorModel to a clean depth render (0 = invalid)."""
    d = np.asarray(depth, np.float32).copy()
    H, W = d.shape
    if sm.edge_sigma_px > 0:
        dv = np.rint(rng.normal(0, sm.edge_sigma_px, d.shape)).astype(np.int64)
        du = np.rint(rng.normal(0, sm.edge_sigma_px, d.shape)).astype(np.int64)
        vv, uu = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        v2 = np.clip(vv + dv, 0, H - 1)
        u2 = np.clip(uu + du, 0, W - 1)
        d = d[v2, u2]
    valid = d > 0
    if sm.noise_sigma > 0:
        sig = sm.noise_sigma
        if sm.depth_sq_noise:
            sig = sig * np.square(np.maximum(d, 0.0) / sm.z_ref)
        d = np.where(valid, d + rng.normal(0, 1.0, d.shape) * sig, 0.0)
    if sm.quantize > 0:
        d = np.where(valid, np.rint(d / sm.quantize) * sm.quantize, 0.0)
    if sm.dropout > 0:
        d = np.where(rng.random(d.shape) < sm.dropout, 0.0, d)
    return d.astype(np.float32)


def default_object_pose(z: float = 0.5) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, z]
    return T


def render_frame_fast(
    object_mesh: meshio.Mesh,
    object_pose: np.ndarray,
    hand: HandModel | None,
    hand_base: np.ndarray,
    hand_q: np.ndarray,
    cam: CameraIntrinsics,
    *,
    n_points: int = 16384,
    noise_sigma: float = 0.0,
    rng: np.random.Generator | None = None,
    sensor: SensorModel | None = None,
) -> np.ndarray:
    """Splat-rendered synthetic depth [H,W] float32 (0 = invalid): dense
    surface samples of the posed object and hand, z-min scatter with a
    radius-2 footprint, then optional noise. The splat runs on the CPU."""
    pts, _ = object_mesh.sample_surface(n_points, seed=7)
    T = np.asarray(object_pose, np.float32)
    pts = pts @ T[:3, :3].T + T[:3, 3]
    if hand is not None:
        hm = hand.merged_mesh(np.asarray(hand_q))
        hp, _ = hm.sample_surface(n_points // 2, seed=8)
        B = np.asarray(hand_base, np.float32)
        pts = np.concatenate([pts, hp @ B[:3, :3].T + B[:3, 3]])
    pts_t = torch.as_tensor(np.asarray(pts, np.float32))
    d = render.splat_depth(
        pts_t, torch.ones(pts_t.shape[0]),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        height=cam.height, width=cam.width, radius=2,
    ).numpy().copy()
    d[~np.isfinite(d)] = 0.0
    if sensor is not None:
        if rng is None:
            rng = np.random.default_rng(0)
        return apply_sensor_model(d, sensor, rng)
    if noise_sigma > 0:
        if rng is None:
            rng = np.random.default_rng(0)
        d = np.where(d > 0, d + rng.normal(0, noise_sigma, d.shape), 0.0)
    return d.astype(np.float32)


def hand_base_for_grasp(object_pose: np.ndarray, offset: float = 0.10) -> np.ndarray:
    """Side grasp: palm on the camera's -x side of the object, fingers (hand
    +z) toward it, finger-separation axis along the view axis, so one finger
    partially occludes the object."""
    T = np.asarray(object_pose, np.float32)
    c = T[:3, 3]
    x_h = np.array([0.0, 0.0, -1.0], np.float32)   # toward camera
    y_h = np.array([0.0, 1.0, 0.0], np.float32)
    z_h = np.array([1.0, 0.0, 0.0], np.float32)    # palm -> object
    R = np.stack([x_h, y_h, z_h], axis=1)
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    out[:3, 3] = c - z_h * offset
    return out
