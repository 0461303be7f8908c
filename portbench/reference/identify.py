"""Library identification written plainly: each candidate model scored at a
pose against one prepared frame, and the candidate named. Plain PyTorch in
float32, TF32 off; imports nothing of the program. Written from the scoring
definitions the program documents (its point-mode projective scorer at the
full-resolution tier, and the observation-side scene support of its ICP),
not from its code.

A candidate's identification score at a pose is the projective fitness
plus `coverage_weight` x its coverage, plus `scene_cov_weight` x (explained
- 1):

  - encoded observation: a pixel with a valid return carries its depth; an
    invalid one is neutral (code -2) where the frame's prep marks it so,
    else "near" (-1) within `ghost_dilate` pixels (a square window) of a
    valid return, else "far" (1e9);
  - each render sample p and its normal n posed by (R, t): R p + t, R n,
    the rotation applied by explicit sums (no matrix product); it projects
    to (u, v) = (x / z fx + cx, y / z fy + cy) where z > 1e-6, and is seen
    where its rounded pixel lies in the frame, it faces the camera (n . p <
    0) and the hand's depth there lies not more than `occlusion_margin` in
    front of it;
  - its observed depth, edge-aware bilinear: the four pixels around (u, v)
    (a pixel outside the frame reads 0: no evidence), the nearest of them
    the reference; a corner weighs in with its bilinear weight where it
    holds a depth (0 < code < 5e8) within 3 `depth_tau` of the reference's;
    the sample's observation is valid where the reference holds a depth
    and the weights sum above 1e-6;
  - a seen sample with a valid observation is counted; it matches where
    |z - observed| < depth_tau (support 1 - |z - observed| / depth_tau) and
    is wrong-side where z - observed < -depth_tau; a seen sample whose
    reference pixel is "far" is a ghost and counts too;
  - fitness = (support - wrong_side_penalty x wrong - invalid_penalty x
    ghost) / max(counted, 1), or -wrong_side_penalty where nothing counted;
    coverage = matches / max(seen, 1);
  - explained: the weighted share of the frame's scene points (weighted as
    the prep leaves them: padding and hand points at 0) whose nearest posed
    model point lies within `scene_cov_tau`, by explicit differences in
    blocks.

The rule that names: each candidate's scores summed over the steps since
the state began (the first step's sum is its score); the candidate whose
sum leads every other's by more than LEAD is named, and none (-1) while no
candidate leads by that much: one frame can fit two models alike, a run of
frames rarely does."""
from __future__ import annotations

import torch

# the lead, in summed score, that names a candidate (the deployment's rule)
LEAD = 2.0
FAR = 1e9
NEAR = -1.0
NEUTRAL = -2.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def encode(depth: torch.Tensor, valid: torch.Tensor, neutral: torch.Tensor | None,
           ghost_dilate: int) -> torch.Tensor:
    """The encoded observation [H, W] of depth [H, W] (valid [H, W] bool)."""
    H, W = depth.shape
    d = int(ghost_dilate)
    near = torch.zeros((H, W), dtype=torch.bool, device=depth.device)
    if d > 0:
        pad = torch.zeros((H + 2 * d, W + 2 * d), dtype=torch.bool, device=depth.device)
        pad[d:d + H, d:d + W] = valid
        for dv in range(2 * d + 1):
            for du in range(2 * d + 1):
                near |= pad[dv:dv + H, du:du + W]
    code = torch.where(near, torch.tensor(NEAR, device=depth.device),
                       torch.tensor(FAR, device=depth.device))
    if neutral is not None:
        code = torch.where(neutral, torch.tensor(NEUTRAL, device=depth.device), code)
    return torch.where(valid, depth, code).to(torch.float32)


def pose_points(pose: torch.Tensor, pts: torch.Tensor, translate: bool = True) -> torch.Tensor:
    """pts [N, 3] posed by pose [4, 4] (the rotation by explicit sums)."""
    R, t = pose[:3, :3], pose[:3, 3]
    out = [R[i, 0] * pts[:, 0] + R[i, 1] * pts[:, 1] + R[i, 2] * pts[:, 2]
           + (t[i] if translate else 0.0) for i in range(3)]
    return torch.stack(out, dim=-1)


def projective(pose, samples, normals, enc, hand, *, fx, fy, cx, cy, depth_tau,
               wrong_side_penalty, occlusion_margin,
               invalid_penalty) -> tuple[torch.Tensor, torch.Tensor]:
    """(fitness, coverage) of one pose [4, 4] of samples and normals [N, 3]
    against the encoded observation `enc` [H, W] and the hand's depth `hand`
    [H, W] (+inf where no hand, or None)."""
    H, W = enc.shape
    p = pose_points(pose, samples)
    n = pose_points(pose, normals, translate=False)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    front = z > 1e-6
    zz = torch.where(front, z, torch.ones_like(z))
    u = x / zz * fx + cx
    v = y / zz * fy + cy
    ur, vr = torch.round(u).long(), torch.round(v).long()
    inside = front & (ur >= 0) & (ur < W) & (vr >= 0) & (vr < H)
    seen = inside & ((n * p).sum(dim=-1) < 0.0)
    if hand is not None:
        h = hand[vr.clamp(0, H - 1), ur.clamp(0, W - 1)]
        seen = seen & ~(inside & (h < z - occlusion_margin))

    # edge-aware bilinear observation
    u0, v0 = torch.floor(u), torch.floor(v)
    au, av = u - u0, v - v0
    u0, v0 = u0.long(), v0.long()
    corners, weights = [], []
    for dv in (0, 1):
        for du in (0, 1):
            cu, cv = u0 + du, v0 + dv
            ok = (cu >= 0) & (cu < W) & (cv >= 0) & (cv < H)
            val = torch.where(ok, enc[cv.clamp(0, H - 1), cu.clamp(0, W - 1)],
                              torch.zeros_like(u))
            corners.append(val)
            weights.append((au if du else 1.0 - au) * (av if dv else 1.0 - av))
    nearest = (av >= 0.5).long() * 2 + (au >= 0.5).long()
    ref = torch.stack(corners, dim=-1).gather(-1, nearest[:, None])[:, 0]

    def holds(c):
        return inside & (c > 0.0) & (c < 0.5 * FAR)

    num = torch.zeros_like(u)
    den = torch.zeros_like(u)
    for c, w in zip(corners, weights):
        wk = torch.where(holds(c) & (torch.abs(c - ref) < 3.0 * depth_tau), w,
                         torch.zeros_like(w))
        num = num + wk * torch.where(holds(c), c, torch.zeros_like(c))
        den = den + wk
    obs_ok = holds(ref) & (den > 1e-6)
    observed = num / torch.clamp(den, min=1e-6)

    counted = seen & obs_ok
    diff = z - observed
    match = counted & (torch.abs(diff) < depth_tau)
    wrong = counted & (diff < -depth_tau)
    ghost = seen & (ref >= 0.5 * FAR)
    support = torch.where(match, 1.0 - torch.abs(diff) / depth_tau,
                          torch.zeros_like(diff)).sum()
    n_counted = (counted.sum() + ghost.sum()).to(torch.float32)
    if n_counted <= 0:
        fitness = torch.tensor(-wrong_side_penalty, dtype=torch.float32, device=enc.device)
    else:
        fitness = (support - wrong_side_penalty * wrong.sum().to(torch.float32)
                   - invalid_penalty * ghost.sum().to(torch.float32)) / n_counted
    coverage = match.sum().to(torch.float32) / torch.clamp(
        seen.sum().to(torch.float32), min=1.0)
    return fitness, coverage


def explained(pose, scene_pts, scene_weights, model_pts, tau, block: int = 512) -> torch.Tensor:
    """The weighted share of scene points [Ns, 3] within `tau` of the posed
    model cloud [Nm, 3]."""
    m = pose_points(pose, model_pts)
    hit = torch.zeros(scene_pts.shape[0], dtype=torch.bool, device=scene_pts.device)
    for s in range(0, scene_pts.shape[0], block):
        a = scene_pts[s:s + block]
        d2 = ((a[:, None, 0] - m[:, 0]) ** 2 + (a[:, None, 1] - m[:, 1]) ** 2
              + (a[:, None, 2] - m[:, 2]) ** 2)
        hit[s:s + block] = torch.amin(d2, dim=1) < tau * tau
    w = scene_weights.to(torch.float32)
    return (w * hit).sum() / torch.clamp(w.sum(), min=1e-9)


def score(candidate: dict, frame: dict, params: dict) -> torch.Tensor:
    """One candidate's identification score at its pose. `candidate`: pose
    [4, 4], samples and normals [Nr, 3], model [Nm, 3]. `frame`: depth,
    valid, neutral and hand [H, W] (the full-resolution tier), scene [Ns,
    3] and weights [Ns], fx, fy, cx, cy. `params`: depth_tau,
    wrong_side_penalty, occlusion_margin, invalid_penalty, ghost_dilate,
    coverage_weight, scene_cov_weight, scene_cov_tau."""
    _no_tf32()
    f32 = torch.float32
    enc = encode(frame["depth"].to(f32), frame["valid"], frame["neutral"],
                 params["ghost_dilate"])
    fit, cov = projective(
        candidate["pose"].to(f32), candidate["samples"].to(f32),
        candidate["normals"].to(f32), enc, frame["hand"],
        fx=frame["fx"], fy=frame["fy"], cx=frame["cx"], cy=frame["cy"],
        depth_tau=params["depth_tau"], wrong_side_penalty=params["wrong_side_penalty"],
        occlusion_margin=params["occlusion_margin"],
        invalid_penalty=params["invalid_penalty"])
    out = fit + params["coverage_weight"] * cov
    if params["scene_cov_weight"] > 0:
        e = explained(candidate["pose"].to(f32), frame["scene"].to(f32),
                      frame["weights"], candidate["model"].to(f32),
                      params["scene_cov_tau"])
        out = out + params["scene_cov_weight"] * (e - 1.0)
    return out


def name(scores, sum_before=None) -> tuple[int, list]:
    """The candidate named at a step: (its index or -1, every candidate's
    sum), from this step's scores [O] and the sums before it [O] (None on
    the first step), in float64."""
    before = sum_before if sum_before is not None else [0.0] * len(scores)
    sums = [float(x) + float(b) for x, b in zip(scores, before)]
    best = max(range(len(sums)), key=lambda o: (sums[o], -o))
    others = [x for o, x in enumerate(sums) if o != best]
    lead = sums[best] - max(others) if others else float("inf")
    return (best if lead > LEAD else -1), sums
