"""Dense nearest-neighbour oracle (counterpart of ops/knn.py).

The expansion form |q|^2 - 2 q.r + |r|^2 with the cross term as one FP32
matrix product (TF32 must be off: it flips neighbours at millimetre
scale). Batched over a leading ref axis where the JAX package vmaps.
"""
from __future__ import annotations

import torch


def pairwise_sqdist(query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[...,N,3] x [...,M,3] -> [...,N,M] squared euclidean distances."""
    q2 = torch.sum(query * query, dim=-1, keepdim=True)           # [...,N,1]
    r2 = torch.sum(ref * ref, dim=-1)[..., None, :]               # [...,1,M]
    cross = query @ ref.transpose(-1, -2)                         # [...,N,M]
    return torch.clamp(q2 - 2.0 * cross + r2, min=0.0)


def nn(query: torch.Tensor, ref: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest neighbour of each query point in ref: (idx [...,N] int64,
    sqdist [...,N]); the first minimal index wins."""
    d2 = pairwise_sqdist(query, ref)
    idx = torch.argmin(d2, dim=-1)
    return idx, torch.gather(d2, -1, idx[..., None])[..., 0]


def nn_gather(
    query: torch.Tensor, ref: torch.Tensor, *extras: torch.Tensor
) -> tuple[torch.Tensor, ...]:
    """NN search + gather of per-ref attributes: (sqdist [N], ref[idx],
    extras[0][idx], ...) for unbatched [N,3] / [M,3] inputs."""
    idx, d2 = nn(query, ref)
    return (d2, ref[idx], *(e[idx] for e in extras))
