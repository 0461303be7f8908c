"""Random draws for the port's sampling sites.

The JAX package splits `jax.random` keys; the port draws from a
`torch.Generator`. The two never give the same numbers, so every sampling
site takes `gen`, which is either a `torch.Generator` or a `Draws` holding
injected arrays (a test hands the JAX package's own draws to the port, in
the order the port consumes them), or a `Stack` of one such source per
object of a library: a request of `shape` then comes back as the objects'
draws stacked on a leading object axis, `(O,) + shape`, object o's from
source o alone. Object o of a library therefore sees the stream that a
single-object frame sees from the same seed.
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


class Stack:
    """One random source (torch.Generator or Draws) per object."""

    def __init__(self, sources):
        self.sources = list(sources)
        if not self.sources:
            raise ValueError("a Stack needs at least one source")
        self.device = self.sources[0].device

    def __len__(self) -> int:
        return len(self.sources)


def fold(gen, idx: int):
    """The source of shard `idx` of a swarm split over a mesh (the
    counterpart of jax.random.fold_in): a torch.Generator seeded from
    `gen`'s initial seed and `idx`, or a Stack of such, one per object.
    Injected Draws are served as they are to shard 0 only: served alike to
    every shard, they would make the shards' swarms copies of one another."""
    if isinstance(gen, Stack):
        return Stack([fold(g, idx) for g in gen.sources])
    if isinstance(gen, Draws):
        if idx:
            raise ValueError(
                f"injected Draws cannot feed shard {idx}: every shard would "
                f"draw the same particles")
        return gen
    words = np.random.SeedSequence([gen.initial_seed(), int(idx)]).generate_state(
        1, np.uint64)
    return torch.Generator(device=gen.device).manual_seed(int(words[0]) >> 1)


def _stacked(draw, gen: Stack, *args) -> torch.Tensor:
    return torch.stack([draw(g, *args) for g in gen.sources])


def normal(gen, shape: tuple) -> torch.Tensor:
    """Standard normal float32 draws of `shape` ((O,) + shape from a
    Stack)."""
    shape = tuple(shape)
    if isinstance(gen, Stack):
        return _stacked(normal, gen, shape)
    if isinstance(gen, Draws):
        return gen.take(shape, torch.float32)
    return torch.randn(shape, generator=gen, device=gen.device)


def uniform(gen, shape: tuple) -> torch.Tensor:
    """Uniform [0, 1) float32 draws of `shape` ((O,) + shape from a
    Stack)."""
    shape = tuple(shape)
    if isinstance(gen, Stack):
        return _stacked(uniform, gen, shape)
    if isinstance(gen, Draws):
        return gen.take(shape, torch.float32)
    return torch.rand(shape, generator=gen, device=gen.device)


def permutation(gen, n: int) -> torch.Tensor:
    """A random permutation of range(n), int64 ([O, n] from a Stack)."""
    if isinstance(gen, Stack):
        return _stacked(permutation, gen, n)
    if isinstance(gen, Draws):
        return gen.take((n,), torch.int64)
    return torch.randperm(n, generator=gen, device=gen.device)
