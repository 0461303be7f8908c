"""Synthetic grasp-sequence generator (counterpart of
datasets/synthetic.py).

Sequences with exact ground truth: the object and the posed hand meshes
are triangle-rasterized (`ops/render.raster_depth`) into depth frames,
with optional sensor noise and dropout, as a hand-held object translates
and rotates through the sequence. `render_frame_fast` is the cheaper
point-splat variant. The renders run on `device` (the card by default);
motion, noise and dropout are numpy draws from one seeded generator, in
the same order and shapes as the reference's, so both packages make the
same sequence from one seed.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ..models.hand import HandModel
from ..ops import render
from ..utils import meshio, se3
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


class SyntheticFrame(NamedTuple):
    depth: np.ndarray        # [H,W] float32 meters, 0 = invalid
    pose_gt: np.ndarray      # [4,4] object model->camera
    hand_base: np.ndarray    # [4,4] hand base->camera
    hand_q: np.ndarray       # [J] nominal joint angles
    rgb: np.ndarray | None = None  # [H,W,3] uint8 shaded color stream


def shade_depth_rgb(depth: np.ndarray) -> np.ndarray:
    """Synthetic color stream: Lambertian shading of the depth surface, so
    that the RGB I/O and visualization path has data. Host-side numpy."""
    d = np.asarray(depth, np.float32)
    valid = d > 0
    dz = np.where(valid, d, np.nan)
    gy, gx = np.gradient(dz)
    gx = np.nan_to_num(gx)
    gy = np.nan_to_num(gy)
    # surface normal ~ (-gx, -gy, px_scale); fixed scale ~ depth/f per px
    nz = np.full_like(d, 2e-3)
    norm = np.sqrt(gx * gx + gy * gy + nz * nz)
    light = np.asarray([0.3, -0.5, 0.81], np.float32)
    lam = (-gx * light[0] - gy * light[1] + nz * light[2]) / np.maximum(norm, 1e-12)
    shade = np.clip(0.25 + 0.75 * np.clip(lam, 0.0, 1.0), 0.0, 1.0)
    base = np.asarray([180, 170, 150], np.float32)  # warm gray material
    img = shade[..., None] * base[None, None]
    img = np.where(valid[..., None], img, 12.0)
    return np.clip(img, 0, 255).astype(np.uint8)


@dataclass
class SyntheticSequenceConfig:
    n_frames: int = 8
    camera: CameraIntrinsics = field(default_factory=CameraIntrinsics)
    object_start: np.ndarray | None = None   # [4,4]; default 0.5m ahead
    step_rot_deg: float = 2.0                # per-frame object rotation
    step_trans: float = 0.004                # per-frame translation (m)
    hand_q: tuple = (0.45, 0.45)             # grasp closure angles
    hand_q_true_offset: float = 0.05         # actual-vs-nominal joint error
    noise_sigma: float = 0.001               # depth noise (m)
    dropout: float = 0.02                    # invalid-pixel fraction
    sensor: SensorModel | None = None        # supersedes noise_sigma/dropout
    hand_base_err_mm: float = 0.0            # hand-mount calibration error:
    hand_base_err_deg: float = 0.0           # the reported hand_base is off
                                             # the true one by this much
                                             # (fixed per sequence)
    seed: int = 0


def default_object_pose(z: float = 0.5) -> np.ndarray:
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.0, 0.0, z]
    return T


def _finish(d: torch.Tensor) -> np.ndarray:
    """A device render -> writable host depth with 0 where empty."""
    d = d.cpu().numpy().copy()
    d[~np.isfinite(d)] = 0.0
    return d


def render_frame(
    object_mesh: meshio.Mesh,
    object_pose: np.ndarray,
    hand: HandModel | None,
    hand_base: np.ndarray,
    hand_q: np.ndarray,
    cam: CameraIntrinsics,
    *,
    noise_sigma: float = 0.0,
    dropout: float = 0.0,
    rng: np.random.Generator | None = None,
    sensor: SensorModel | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Exact depth render [H,W] float32 (0 = invalid) of the object and the
    posed hand, rastered on `device`, then the sensor model on the host.
    `sensor` supersedes the flat noise_sigma/dropout arguments."""
    scene = object_mesh.transformed(object_pose)
    if hand is not None:
        scene = scene.merged(hand.merged_mesh(np.asarray(hand_q)).transformed(hand_base))
    d = _finish(render.raster_depth(
        torch.as_tensor(np.asarray(scene.vertices, np.float32), device=device),
        torch.as_tensor(np.asarray(scene.faces, np.int64), device=device),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        height=cam.height, width=cam.width,
    ))
    if rng is None:
        rng = np.random.default_rng(0)
    if sensor is not None:
        return apply_sensor_model(d, sensor, rng)
    if noise_sigma > 0:
        d = np.where(d > 0, d + rng.normal(0, noise_sigma, d.shape), 0.0)
    if dropout > 0:
        d = np.where(rng.random(d.shape) < dropout, 0.0, d)
    return d.astype(np.float32)


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
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Splat-rendered synthetic depth [H,W] float32 (0 = invalid): dense
    surface samples of the posed object and hand, z-min scatter with a
    radius-2 footprint on `device`, then optional noise on the host."""
    pts, _ = object_mesh.sample_surface(n_points, seed=7)
    T = np.asarray(object_pose, np.float32)
    pts = pts @ T[:3, :3].T + T[:3, 3]
    if hand is not None:
        hm = hand.merged_mesh(np.asarray(hand_q))
        hp, _ = hm.sample_surface(n_points // 2, seed=8)
        B = np.asarray(hand_base, np.float32)
        pts = np.concatenate([pts, hp @ B[:3, :3].T + B[:3, 3]])
    pts_t = torch.as_tensor(np.asarray(pts, np.float32), device=device)
    d = _finish(render.splat_depth(
        pts_t, torch.ones(pts_t.shape[0], device=device),
        fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        height=cam.height, width=cam.width, radius=2,
    ))
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


def _twist_pose(w: np.ndarray, v: np.ndarray) -> np.ndarray:
    """exp of the twist (w, v) as a float32 [4,4], on the host."""
    xi = torch.as_tensor(np.concatenate([w, v]).astype(np.float32))
    return se3.se3_exp(xi).numpy()


def _unit_draw(rng: np.random.Generator, scale: float) -> np.ndarray:
    x = rng.normal(size=3)
    return x / np.linalg.norm(x) * scale


def generate_sequence(
    object_mesh: meshio.Mesh,
    hand: HandModel | None,
    cfg: SyntheticSequenceConfig,
    device: torch.device | str = "cuda",
) -> list[SyntheticFrame]:
    """A rigid grasp moving through space: hand and object move together,
    exact ground truth every frame. Frames are rastered on `device`."""
    rng = np.random.default_rng(cfg.seed)
    pose = (
        np.asarray(cfg.object_start, np.float32)
        if cfg.object_start is not None
        else default_object_pose()
    )
    q_nom = np.asarray(cfg.hand_q, np.float32)
    q_true = q_nom + cfg.hand_q_true_offset
    frames = []
    step_w = _unit_draw(rng, np.radians(cfg.step_rot_deg))
    step_v = _unit_draw(rng, cfg.step_trans)
    delta = _twist_pose(step_w, step_v)
    # hand-mount calibration error: one fixed perturbation per sequence
    # between the true base (renders the depth) and the reported base
    # (handed to the estimator)
    base_err = np.eye(4, dtype=np.float32)
    if cfg.hand_base_err_mm > 0 or cfg.hand_base_err_deg > 0:
        w = _unit_draw(rng, np.radians(cfg.hand_base_err_deg))
        v = _unit_draw(rng, cfg.hand_base_err_mm * 1e-3)
        base_err = _twist_pose(w, v)
    for _ in range(cfg.n_frames):
        hb_true = hand_base_for_grasp(pose)
        hb_reported = (base_err @ hb_true).astype(np.float32)
        depth = render_frame(
            object_mesh, pose, hand, hb_true, q_true, cfg.camera,
            noise_sigma=cfg.noise_sigma, dropout=cfg.dropout, rng=rng,
            sensor=cfg.sensor, device=device,
        )
        frames.append(
            SyntheticFrame(
                depth=depth, pose_gt=pose.copy(), hand_base=hb_reported,
                hand_q=q_nom, rgb=shade_depth_rgb(depth),
            )
        )
        # rigid motion about the object's own center
        c = pose[:3, 3].copy()
        A = np.eye(4, dtype=np.float32)
        A[:3, 3] = c
        B = np.eye(4, dtype=np.float32)
        B[:3, 3] = -c
        pose = (A @ delta @ B @ pose).astype(np.float32)
    return frames
