"""Adaptive-hand kinematic model and render-space config scoring
(counterpart of models/hand.py).

The kinematic tree is a Python loop over the links; joint angles are
tensors with any leading batch shape, so the K sampled finger configs
are one batched FK instead of a vmap. `segment_mask`, `depth`,
`depth_union`, `load_hand_spec` and `make_model_o_hand` are not ported yet
(the estimator makes its hand masks itself).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import render
from ..utils import meshio, rng, se3


def _unit(axis) -> np.ndarray:
    axis = np.asarray(axis, np.float32)
    n = np.linalg.norm(axis)
    return axis / n if n > 0 else axis


@dataclass
class HandLink:
    """One rigid link of the hand.

    origin: static [4,4] transform parent-frame -> joint frame.
    axis: revolute axis in joint frame ([0,0,0] = fixed link).
    joint: index into the actuated-angle vector q (-1 = fixed).
    coupling/rest: link angle = coupling * q[joint] + rest.
    """
    name: str
    mesh: meshio.Mesh
    parent: int
    origin: np.ndarray
    axis: np.ndarray
    joint: int = -1
    coupling: float = 1.0
    rest: float = 0.0


class HandModel:
    """Device-ready hand: FK + point clouds + segmentation + occlusion."""

    def __init__(self, links: list[HandLink], n_joints: int,
                 points_per_link: int = 256,
                 device: torch.device | str = "cuda"):
        pts, nrms = [], []
        for li, link in enumerate(links):
            p, n = link.mesh.sample_surface(points_per_link, seed=1000 + li)
            pts.append(p)
            nrms.append(n)
        self._assign(links, n_joints, np.stack(pts), np.stack(nrms),
                     np.stack([l.origin for l in links]), device)

    @classmethod
    def from_arrays(cls, links: list[HandLink], n_joints: int, link_pts,
                    link_normals, origins,
                    device: torch.device | str = "cuda") -> "HandModel":
        """Build from precomputed link clouds (see convert.hand_from_numpy)."""
        hand = cls.__new__(cls)
        hand._assign(links, n_joints, link_pts, link_normals, origins, device)
        return hand

    def _assign(self, links, n_joints, link_pts, link_normals, origins,
                device) -> None:
        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        self.links = links
        self.n_joints = int(n_joints)
        self.device = torch.device(device)
        self._link_pts = t(link_pts)          # [L,Pl,3]
        self._link_normals = t(link_normals)  # [L,Pl,3]
        self._origins = t(origins)            # [L,4,4]
        self._axes = [t(_unit(l.axis)) for l in links]
        self.points_per_link = int(self._link_pts.shape[1])

    @property
    def num_links(self) -> int:
        return len(self.links)

    @property
    def num_points(self) -> int:
        return self.num_links * self.points_per_link

    # -- forward kinematics -------------------------------------------------

    def fk(self, q: torch.Tensor) -> torch.Tensor:
        """Joint angles q [...,J] -> link transforms [...,L,4,4] in the
        hand-base frame."""
        batch = q.shape[:-1]
        eye = torch.eye(4, dtype=torch.float32, device=q.device).expand(batch + (4, 4))
        Ts = []
        for li, link in enumerate(self.links):
            parent_T = eye if link.parent < 0 else Ts[link.parent]
            local = self._origins[li].expand(batch + (4, 4))
            if link.joint >= 0:
                ang = link.coupling * q[..., link.joint] + link.rest
                R = se3.so3_exp(self._axes[li] * ang[..., None])
                zero = torch.zeros(batch + (3,), dtype=R.dtype, device=R.device)
                local = se3.compose(local, se3.make_pose(R, zero))
            Ts.append(se3.compose(parent_T, local))
        return torch.stack(Ts, dim=-3)

    def cloud(self, base_pose: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        """Hand surface points in camera frame: base [...,4,4], q [...,J] ->
        [..., L*Pl, 3]."""
        Ts = se3.compose(base_pose[..., None, :, :], self.fk(q))   # [...,L,4,4]
        pts = se3.transform_points(Ts, self._link_pts)              # [...,L,Pl,3]
        return pts.reshape(pts.shape[:-3] + (-1, 3))

    def sampled_clouds(
        self, gen, base_pose: torch.Tensor, q_nominal: torch.Tensor,
        sigma: float, n_samples: int,
    ) -> torch.Tensor:
        """K sampled finger configs -> [K, L*Pl, 3]. The first sample is the
        nominal configuration. Draws: normals of shape (K, J)."""
        noise = rng.normal(gen, (n_samples, self.n_joints)) * sigma
        noise[0] = 0.0
        qs = torch.clamp(q_nominal[None] + noise, 0.0, math.pi)
        return self.cloud(base_pose, qs)

    # -- hand-mount calibration refinement ------------------------------------

    def refine_base(
        self,
        gen,
        depth: torch.Tensor,     # [H,W] observed depth, meters
        valid: torch.Tensor,     # [H,W] bool
        base0: torch.Tensor,     # [4,4] reported hand base (camera frame)
        q: torch.Tensor,         # [J] nominal joint angles
        *,
        fx: float, fy: float, cx: float, cy: float,
        height: int, width: int,
        iters: int = 3,
        candidates: int = 16,
        rot_sigma: float = 0.06,
        trans_sigma: float = 0.012,
        q_sigma: float = 0.12,
        anneal: float = 0.5,
        tau: float = 0.008,
        radius: int = 3,
    ) -> torch.Tensor:
        """Annealed render-space search correcting the hand BASE pose (the
        hand-mount calibration error the sampled finger configs cannot
        absorb). Each round scores `candidates` bases, the incumbent in
        slot 0 and the rest perturbed around it, each with its own sampled
        joint config, by `config_agreement` against the observed depth;
        the sigmas shrink by `anneal` per round. Returns the winning base.
        Draws per round: the perturbation's rotation and translation
        normals, each (candidates - 1, 3), then the joint normals
        (candidates, J)."""
        best_b, best_q = base0, q
        sr, st, sq = rot_sigma, trans_sigma, q_sigma
        for _ in range(iters):
            cands = torch.cat([
                best_b[None],
                se3.perturb_pose(gen, best_b, sr, st, shape=(candidates - 1,)),
            ])
            qn = rng.normal(gen, (candidates, self.n_joints)) * sq
            qn[0] = 0.0
            cq = torch.clamp(best_q[None] + qn, 0.0, math.pi)
            agree = self.config_agreement(
                self.cloud(cands, cq), depth, valid,
                fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
                tau=tau, radius=radius,
            )
            i = torch.argmax(agree)
            best_b, best_q = cands[i], cq[i]
            sr, st, sq = sr * anneal, st * anneal, sq * anneal
        return best_b

    # -- observation-driven configuration weighting ---------------------------

    @staticmethod
    def config_agreement(
        clouds: torch.Tensor,        # [K,Nh,3] sampled configs, camera frame
        depth: torch.Tensor,         # [H,W] observed depth (meters)
        valid: torch.Tensor,         # [H,W] bool
        *,
        fx: float, fy: float, cx: float, cy: float,
        height: int, width: int,
        tau: float = 0.008,
        radius: int = 3,
    ) -> torch.Tensor:
        """[K] render-space agreement of each sampled finger config with the
        observed depth: continuous match support, minus in-front
        contradictions, minus half the ghost pixels, per rendered pixel."""
        inf = float("inf")
        obs = torch.where(valid, depth, inf)
        rend = render.splat_depth_batched(
            clouds, torch.ones(clouds.shape[:2], dtype=clouds.dtype,
                               device=clouds.device),
            fx=fx, fy=fy, cx=cx, cy=cy, height=height, width=width,
            radius=radius,
        )                                                       # [K,H,W]
        r_valid = torch.isfinite(rend)
        o_valid = torch.isfinite(obs)
        both = r_valid & o_valid[None]
        diff = torch.where(
            both,
            torch.where(r_valid, rend, 0.0) - torch.where(o_valid, obs, 0.0)[None],
            inf,
        )
        dt = clouds.dtype
        support = torch.clamp(1.0 - torch.abs(diff) / tau, 0.0, 1.0)
        front = (both & (diff < -tau)).to(dt)
        ghost = (r_valid & ~o_valid[None]).to(dt)
        n = torch.clamp(torch.sum(r_valid.to(dt), (1, 2)), min=1.0)
        return (torch.sum(support, (1, 2)) - torch.sum(front, (1, 2))
                - 0.5 * torch.sum(ghost, (1, 2))) / n

    def merged_mesh(self, q) -> meshio.Mesh:
        """Host-side posed hand mesh (for synthetic frames)."""
        Ts = self.fk(torch.as_tensor(np.asarray(q, np.float32),
                                     device=self.device)).cpu().numpy()
        out: meshio.Mesh | None = None
        for li, link in enumerate(self.links):
            m = link.mesh.transformed(Ts[li])
            out = m if out is None else out.merged(m)
        if out is None:
            raise ValueError("hand has no links")
        return out


def make_t42_hand(points_per_link: int = 256,
                  device: torch.device | str = "cuda") -> HandModel:
    """Two-finger underactuated gripper approximating the OpenHand T42
    (palm at the origin, fingers along +z, joint axes along y; one tendon
    angle per finger, distal joints coupled at 0.7x with a rest curl)."""
    palm = meshio.make_box((0.075, 0.028, 0.04), center=(0.0, 0.0, 0.0))
    prox = meshio.make_capsule(radius=0.010, length=0.050)
    dist = meshio.make_capsule(radius=0.008, length=0.040)

    def T(t, R=np.eye(3)):
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = R
        M[:3, 3] = t
        return M

    links = [
        HandLink("palm", palm, parent=-1, origin=T([0, 0, 0]), axis=np.zeros(3)),
        HandLink("fA_prox", prox, parent=0, origin=T([+0.034, 0.0, 0.018]),
                 axis=np.array([0, 1, 0]), joint=0, coupling=-1.0),
        HandLink("fA_dist", dist, parent=1, origin=T([0.0, 0.0, 0.050]),
                 axis=np.array([0, 1, 0]), joint=0, coupling=-0.7, rest=-0.15),
        HandLink("fB_prox", prox, parent=0, origin=T([-0.034, 0.0, 0.018]),
                 axis=np.array([0, 1, 0]), joint=1, coupling=+1.0),
        HandLink("fB_dist", dist, parent=3, origin=T([0.0, 0.0, 0.050]),
                 axis=np.array([0, 1, 0]), joint=1, coupling=+0.7, rest=0.15),
    ]
    return HandModel(links, n_joints=2, points_per_link=points_per_link,
                     device=device)
