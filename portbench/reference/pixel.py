"""The pixel-mode scorer written plainly: render-and-compare of pose
hypotheses (Wen et al., ICRA 2020, arXiv:2003.03518: each hypothesis
rendered into a z-buffer and compared with the observed depth pixel by
pixel, pixels behind the hand left out). Plain PyTorch in float32, TF32
off; imports nothing of the program.

For each particle of a block, with camera-frame samples (x, y, z) and
weights w:

  - a sample renders where z > 1e-6 and w > 0, at the pixel (round(x / z *
    fx + cx), round(y / z * fy + cy)), rounded half to even, if that lies
    within `radius` pixels of the frame;
  - each particle has its own full z-buffer, padded by `radius`, filled
    sample by sample with the least depth; the rendered depth of a pixel is
    the least of the buffer over the (2 radius + 1)^2 window around it,
    +inf where nothing rendered;
  - a pixel is visible where its depth is finite and not behind the hand
    (hand depth < rendered - occlusion_margin); a visible pixel with a
    valid observation counts, matches where |rendered - observed| <
    depth_tau (support 1 - |rendered - observed| / depth_tau), and is
    wrong-side where rendered - observed < -depth_tau; a visible pixel
    without a valid observation is a ghost where the encoded observation
    says no return lies near it (code 1e9, at or above GHOST_AT);
  - fitness = (support - wrong_side_penalty * wrong - invalid_penalty *
    ghost) / max(counted + ghost, 1), or -wrong_side_penalty where nothing
    counted; coverage = matches / max(valid observed pixels, 1).

The counts are exact integers. `render_dtype` rounds each sample's depth
to a lower precision before it enters the z-buffer: the control that the
comparison must catch."""
from __future__ import annotations

import torch

GHOST_AT = 5e8   # half the encoded observation's no-return code (1e9)


def score(pts_cam: torch.Tensor, weights: torch.Tensor, observed: torch.Tensor,
          observed_valid: torch.Tensor, observed_enc: torch.Tensor,
          hand_depth: torch.Tensor | None, *, fx: float, fy: float, cx: float,
          cy: float, radius: int, depth_tau: float, wrong_side_penalty: float,
          occlusion_margin: float, invalid_penalty: float,
          render_dtype: torch.dtype = torch.float32) -> dict:
    """A block of particles [B, Nr, 3] with weights [B, Nr] (or [Nr]), all
    against one observation: observed [H, W] depth, observed_valid [H, W]
    bool, observed_enc [H, W], hand_depth [H, W] (+inf where no hand) or
    None. Returns per particle `fitness`, `coverage`, `support` (float32)
    and the counts `counted` (counted + ghost pixels), `matches`, `wrong`
    and `ghost` (int64)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    f32 = torch.float32
    dev = pts_cam.device
    B, Nr = pts_cam.shape[:2]
    H, W = observed.shape
    r = int(radius)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    x, y, z = pts_cam[..., 0], pts_cam[..., 1], pts_cam[..., 2]
    w = weights.expand(B, Nr)
    ok = (z > 1e-6) & (w > 0)
    zs = torch.where(ok, z, torch.ones_like(z))
    u = torch.round(x / zs * fx + cx)
    v = torch.round(y / zs * fy + cy)
    ok = ok & (u >= -r) & (u < W + r) & (v >= -r) & (v < H + r)
    Hp, Wp = H + 2 * r, W + 2 * r
    dump = Hp * Wp                       # where the samples that render nowhere go
    flat = torch.where(ok, (v + r) * Wp + (u + r), torch.full_like(u, dump)).long()
    depth = torch.where(ok, z.to(render_dtype).to(f32), inf)

    # each particle's z-buffer, sample by sample
    zbuf = torch.full((B, dump + 1), float("inf"), dtype=f32, device=dev)
    rows = torch.arange(B, device=dev)
    for s in range(Nr):
        at = flat[:, s]
        zbuf[rows, at] = torch.minimum(zbuf[rows, at], depth[:, s])
    padded = zbuf[:, :dump].reshape(B, Hp, Wp)
    rendered = torch.full((B, H, W), float("inf"), dtype=f32, device=dev)
    for dv in range(2 * r + 1):
        for du in range(2 * r + 1):
            rendered = torch.minimum(rendered, padded[:, dv:dv + H, du:du + W])

    # each pixel classified, then counted and summed
    tau = torch.tensor(depth_tau, dtype=f32, device=dev)
    visible = torch.isfinite(rendered)
    if hand_depth is not None:
        visible = visible & ~(hand_depth < rendered - occlusion_margin)
    valid = observed_valid.to(torch.bool)
    counted = visible & valid
    diff = rendered - torch.where(valid, observed, inf)
    ad = torch.abs(diff)
    match = counted & (ad < tau)
    wrong = counted & (diff < -tau)
    ghost = visible & ~valid & (observed_enc >= GHOST_AT)
    support = torch.sum(torch.where(match, 1.0 - ad / tau, 0.0), dim=(1, 2))
    n = {k: torch.sum(m, dim=(1, 2)) for k, m in
         (("counted", counted), ("matches", match), ("wrong", wrong), ("ghost", ghost))}
    n["counted"] = n["counted"] + n["ghost"]
    n_counted = n["counted"].to(f32)
    fitness = ((support - wrong_side_penalty * n["wrong"].to(f32)
                - invalid_penalty * n["ghost"].to(f32)) / torch.clamp(n_counted, min=1.0))
    fitness = torch.where(n["counted"] > 0, fitness,
                          torch.full_like(fitness, -wrong_side_penalty))
    n_obs = torch.clamp(torch.sum(valid).to(f32), min=1.0)
    coverage = n["matches"].to(f32) / n_obs
    return dict(fitness=fitness, coverage=coverage, support=support, **n)


def score_in_blocks(pts_cam: torch.Tensor, weights: torch.Tensor, *images,
                    block: int = 64, **kw) -> dict:
    """`score` over [P, Nr, 3] particles in blocks of `block`, each block's
    z-buffers [block, H, W] at a time; the results concatenated."""
    w = weights.expand(pts_cam.shape[:2])
    parts = [score(pts_cam[i:i + block], w[i:i + block], *images, **kw)
             for i in range(0, pts_cam.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
