"""The one traffic generator: a traffic file's parameters and a
configuration's deployment -> the frames a camera and a hand's encoders
deliver, with the exact ground truth of each.

Two kinds of mix, both from parameters alone:

- `sequence`: each object held in a side grasp moves rigidly about its own
  centre, by one of a fixed set of per-frame twists (`motion`) in each of
  its segments, in an order that the mix's `order_seed` draws for each
  object. The path is centred on `start`. Played forward and back
  (`pingpong`), the motion never jumps.
- `grasps`: a fixed pool of independent grasps, each a uniform
  orientation at a uniform position in the box `grasp`, played in turn
  (`cycle`).

The mix's own seeds fix every path and grasp, so every run serves the same
poses; the run's seed draws only the sensor's noise and (in the loops) the
program's seeds.

Frames are rastered on the device (`reference/render.py`), handed over as
host float32 depth [H,W] in metres (0 = no return), with the hand's
reported base pose [4,4] and nominal joint readings [J]. The true joints
are the nominal ones plus `hand_q_true_offset`, as a tendon hand's
encoders read them.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import geometry, render


@dataclass
class Traffic:
    loop: str                 # the driver that serves it (loops/<loop>.py)
    kinds: list               # one test object per scene
    meshes: list              # geometry.Mesh per object
    depth: np.ndarray         # [N,O,H,W] float32 host frames
    pose_gt: np.ndarray       # [N,O,4,4] object model -> camera
    hand_base: np.ndarray     # [N,O,4,4] reported hand base -> camera
    hand_q: np.ndarray        # [J] nominal joint readings
    playback: str             # "pingpong" or "cycle"
    setup_frames: int         # frames served in set-up, before the window

    def index(self, i: int) -> int:
        """The frame served i-th."""
        n = self.depth.shape[0]
        if self.playback == "cycle" or n == 1:
            return i % n
        p = i % (2 * (n - 1))
        return p if p < n else 2 * (n - 1) - p


def _unit(rng: np.random.Generator, scale: float) -> np.ndarray:
    x = rng.normal(size=3)
    return x / np.linalg.norm(x) * scale


def _twists(mix: dict) -> list[np.ndarray]:
    """The mix's fixed set of per-frame twists, drawn from its own
    `directions_seed`: the same set for every run."""
    m = mix["motion"]
    rng = np.random.default_rng(int(m["directions_seed"]))
    return [geometry.se3_exp(_unit(rng, np.radians(m["step_rot_deg"])),
                             _unit(rng, m["step_trans"]))
            for _ in range(int(m["segments"]))]


def _sequence(o: int, n: int, mix: dict) -> np.ndarray:
    """[n,4,4] poses of object o: the fixed twists, one per segment of
    n / segments frames, in the order `order_seed` draws for the object,
    each applied per frame about the object's own centre; the centre's path
    centred on the start point."""
    twists = _twists(mix)
    order = np.random.default_rng([int(mix["motion"]["order_seed"]), o]).permutation(
        len(twists))
    per = -(-n // len(twists))
    pose = np.eye(4, dtype=np.float32)
    out = []
    for k in range(n):
        out.append(pose.copy())
        c = pose[:3, 3].copy()
        A, B = np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)
        A[:3, 3], B[:3, 3] = c, -c
        pose = (A @ twists[order[k // per]] @ B @ pose).astype(np.float32)
    out = np.stack(out)
    out[:, :3, 3] += np.asarray(mix["start"], np.float32) - out[:, :3, 3].mean(axis=0)
    return out


def _grasps(o: int, n: int, mix: dict) -> np.ndarray:
    """The pool of n grasps drawn from the mix's own `pool_seed`, the same
    for every run and object."""
    g = mix["grasp"]
    pool_rng = np.random.default_rng(int(g["pool_seed"]))
    out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for k in range(n):
        out[k, :3, :3] = geometry.random_rotation(pool_rng)
        out[k, :3, 3] = [pool_rng.uniform(*g["x"]), pool_rng.uniform(*g["y"]),
                         pool_rng.uniform(*g["z"])]
    return out


def make(config: dict, mix: dict, seed: int, device) -> Traffic:
    """The mix's frames for every object of the configuration, from `seed`."""
    kinds = list(config["objects"])
    meshes = [geometry.make_test_object(k) for k in kinds]
    links = geometry.hand_links(config["hand"])
    q_nom = np.asarray(mix["hand_q"], np.float32)
    hand = geometry.hand_mesh(links, q_nom + mix["hand_q_true_offset"])
    cam = config["camera"]
    n = int(mix["frames"])
    O = len(kinds)
    root = np.random.SeedSequence(int(seed))
    poses = np.zeros((n, O, 4, 4), np.float32)
    make_poses = {"sequence": _sequence, "grasps": _grasps}[mix["kind"]]
    for o in range(O):
        poses[:, o] = make_poses(o, n, mix)
    bases = np.stack([[geometry.hand_base_for_grasp(p) for p in row] for row in poses])
    gen = torch.Generator(device=device)
    gen.manual_seed(int(root.generate_state(1, np.uint64)[0] >> 1))
    depth = np.zeros((n, O, int(cam["height"]), int(cam["width"])), np.float32)
    for k in range(n):
        for o in range(O):
            scene = meshes[o].transformed(poses[k, o]).merged(
                hand.transformed(bases[k, o]))
            clean = render.raster_depth(
                torch.as_tensor(scene.vertices, device=device),
                torch.as_tensor(scene.faces, device=device), cam)
            depth[k, o] = render.sensor_model(clean, mix["sensor"], gen).cpu().numpy()
    return Traffic(loop=mix["loop"], kinds=kinds, meshes=meshes, depth=depth,
                   pose_gt=poses, hand_base=bases.astype(np.float32), hand_q=q_nom,
                   playback=mix["playback"], setup_frames=int(mix["setup_frames"]))
