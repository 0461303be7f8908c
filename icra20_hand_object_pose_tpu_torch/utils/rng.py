"""Random draws for the port's sampling sites.

The JAX package splits `jax.random` keys; the port draws from a
`torch.Generator`. The two never give the same numbers, so every sampling
site takes `gen`, which is either a `torch.Generator` or a `Draws` holding
injected arrays (a test hands the JAX package's own draws to the port, in
the order the port consumes them).
"""
from __future__ import annotations

import numpy as np
import torch


class Draws:
    """Injected draws, served first in, first out. Each request must match
    the next array's shape exactly."""

    def __init__(self, *arrays, device: torch.device | str = "cpu"):
        self._queue = [np.asarray(a) for a in arrays]
        self.device = torch.device(device)

    def take(self, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
        if not self._queue:
            raise IndexError(f"no injected draw left for shape {shape}")
        a = self._queue.pop(0)
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"injected draw has shape {a.shape}, site wants {shape}")
        return torch.tensor(a, dtype=dtype, device=self.device)

    def __len__(self) -> int:
        return len(self._queue)


def normal(gen, shape: tuple) -> torch.Tensor:
    """Standard normal float32 draws of `shape`."""
    shape = tuple(shape)
    if isinstance(gen, Draws):
        return gen.take(shape, torch.float32)
    return torch.randn(shape, generator=gen, device=gen.device)


def uniform(gen, shape: tuple) -> torch.Tensor:
    """Uniform [0, 1) float32 draws of `shape`."""
    shape = tuple(shape)
    if isinstance(gen, Draws):
        return gen.take(shape, torch.float32)
    return torch.rand(shape, generator=gen, device=gen.device)


def permutation(gen, n: int) -> torch.Tensor:
    """A random permutation of range(n), int64."""
    if isinstance(gen, Draws):
        return gen.take((n,), torch.int64)
    return torch.randperm(n, generator=gen, device=gen.device)
