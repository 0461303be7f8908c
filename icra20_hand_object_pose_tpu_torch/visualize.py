"""Overlay visualization: pose estimates rendered over observed depth
(counterpart of visualize.py). The two splats run on the object's device;
the compositing is host-side numpy and the pure-Python PNG writer, with no
display dependency.

An overlay frame encodes, per pixel:
  - observed depth as grayscale background;
  - the object hypothesis silhouette, green where the rendered depth
    agrees with the observation (within tau), red where it disagrees
    (wrong pose / unexplained), blue where the hand occludes it;
  - the hand model silhouette as a dim cyan tint.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .models.hand import HandModel
from .models.object_model import ObjectModel
from .ops import render
from .utils import pngio
from .utils.config import CameraIntrinsics


def depth_to_gray(depth: np.ndarray, d_min=0.2, d_max=1.2) -> np.ndarray:
    """[H,W] meters -> uint8 grayscale (near bright, far dark, invalid 0)."""
    d = np.asarray(depth)
    valid = d > 0
    t = np.clip((d - d_min) / max(d_max - d_min, 1e-6), 0.0, 1.0)
    g = ((1.0 - t) * 205 + 50).astype(np.uint8)
    return np.where(valid, g, 0).astype(np.uint8)


def render_overlay(
    depth: np.ndarray,          # [H,W] observed meters (0 invalid)
    pose: np.ndarray,           # [4,4] estimated object pose
    obj: ObjectModel,
    cam: CameraIntrinsics,
    hand: HandModel | None = None,
    hand_base: np.ndarray | None = None,
    hand_q: np.ndarray | None = None,
    *,
    rgb: np.ndarray | None = None,  # [H,W,3] uint8 color stream background
    depth_tau: float = 0.01,
) -> np.ndarray:
    """-> uint8 [H,W,3] overlay image. When the sequence has an RGB
    stream it becomes the background; otherwise depth is grayscaled."""
    H, W = cam.height, cam.width
    if rgb is not None:
        img = np.asarray(rgb, np.float32).copy()
    else:
        gray = depth_to_gray(depth)
        img = np.stack([gray, gray, gray], axis=-1).astype(np.float32)

    def splat(pts: np.ndarray) -> np.ndarray:
        t = torch.as_tensor(np.asarray(pts, np.float32), device=obj.device)
        return render.splat_depth(
            t, torch.ones(t.shape[0], device=obj.device),
            fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
            height=H, width=W, radius=1,
        ).cpu().numpy()

    # object hypothesis depth via point splat
    pose = np.asarray(pose, np.float32)
    od = splat(obj.render_pts.cpu().numpy() @ pose[:3, :3].T + pose[:3, 3])
    o_vis = np.isfinite(od)

    hd = np.full((H, W), np.inf, np.float32)
    if hand is not None and hand_base is not None and hand_q is not None:
        hm = hand.merged_mesh(np.asarray(hand_q))
        hp, _ = hm.sample_surface(8192, seed=11)
        B = np.asarray(hand_base, np.float32)
        hd = splat(hp @ B[:3, :3].T + B[:3, 3])
        h_vis = np.isfinite(hd)
        # dim cyan hand silhouette
        img[h_vis] = img[h_vis] * 0.6 + np.array([0, 60, 60])

    occluded = o_vis & (hd < od - 0.005)
    agree = o_vis & (depth > 0) & (np.abs(od - depth) < depth_tau) & ~occluded
    disagree = o_vis & ~agree & ~occluded

    img[agree] = img[agree] * 0.4 + np.array([0, 153, 0])
    img[disagree] = img[disagree] * 0.4 + np.array([153, 0, 0])
    img[occluded] = img[occluded] * 0.4 + np.array([0, 0, 153])
    return np.clip(img, 0, 255).astype(np.uint8)


def save_overlay(path: str, *args, **kwargs) -> None:
    pngio.write_png_rgb(path, render_overlay(*args, **kwargs))


def save_sequence_overlays(
    out_dir: str, frames, poses, obj, cam, hand=None, **kwargs
) -> list[str]:
    """One overlay PNG per (frame, estimated pose) pair."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, (fr, pose) in enumerate(zip(frames, poses)):
        p = os.path.join(out_dir, f"overlay_{i:06d}.png")
        save_overlay(
            p, fr.depth, np.asarray(pose), obj, cam,
            hand=hand,
            hand_base=getattr(fr, "hand_base", None),
            hand_q=getattr(fr, "hand_q", None),
            **kwargs,
        )
        paths.append(p)
    return paths
