"""Compiled programs: the port's counterpart of `jax.jit`.

The reference compiles each of its device programs once per static key
(`Estimator._step_jit`, `LibrarySweep._sweep_jit`: `jax.jit` with static
arguments) and runs the compiled program on every later call. The port
captures each as a CUDA graph once per key and replays it:

    programs = Programs()                    # one cache per estimator / sweep
    out = programs(fn, seeds, inputs, **static)

`fn(source, *inputs, **static)` is the traced function: `source` an
`rng.Stack` of one torch.Generator per seed, `inputs` the tensor inputs
(numpy arrays or tensors; each lives in a float32 buffer of its shape), and
`static` the static arguments. A key holds the static arguments, the
inputs' shapes, the number of seeds and the device.

On a CUDA device the first call of a key

  1. warms `fn` up on its owner's capture stream: a lazy allocation, the
     kernels' build and the constants' cache (`constant`) happen here, as
     the reference compiles at its first call;
  2. captures one call of `fn` into a CUDA graph, reading static input
     buffers and drawing from the program's own generators, registered with
     the graph. The graphs of one owner share one memory pool, captured on
     one stream (the allocator reuses a block only on the stream that freed
     it): they replay one at a time and their outputs are cloned, so one
     program's intermediates may take the memory of another's. The graph
     is kept beside its instance, so that its nodes can be counted
     (`Program.nodes`);

and every call copies the inputs into the buffers, reseeds the generators
(`manual_seed`: a fresh Philox stream from offset 0, the draws of an eager
call seeded alike), replays the graph and returns clones of its outputs (a
later replay overwrites the graph's own). A failed capture or replay
raises. On the CPU a program calls `fn` directly: the plain path.

Inside a traced function nothing may read the device from the host (no
`.item()`, `if` on a tensor, `nonzero`, boolean-mask indexing, or an
operator that checks its result on the host, as `torch.linalg.eigh` does)
or copy from the host (a host array becomes a device tensor through
`constant`). The kernels' launches and the tracer's counters are counted
by the calls that make them (utils/profiling.py), and a replay makes none:
a program records what its capture counted (`profiling.recording`) and
counts it again on every replay (`profiling.recount`).

With the tracer on (utils/profiling.py) a call is the span `program.call`,
with `program.capture` (warm-up and capture), `program.inputs`,
`program.replay` and `program.outputs` inside; it counts
`program.captures`, `program.replays` and `program.kernels` (kernel nodes
replayed), reads its last replay's stage times before the next, and a
capture records the traced function's stage marks into the graph.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import profiling, rng

_CONSTANTS: dict = {}


def constant(values, device) -> torch.Tensor:
    """`values` (an array) on `device`, made once per value and kept for
    the life of the process, read-only: a captured program reads it at the
    address its capture saw, and a copy from the host cannot be captured.
    For the small index and radius arrays a traced function builds from its
    static arguments."""
    a = np.ascontiguousarray(values)
    dev = torch.device(device)
    key = (dev, a.dtype.str, a.shape, a.tobytes())
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(a, device=dev)
    return t


def _clone(out):
    """The outputs (a NamedTuple or tuple of tensors and Nones) copied."""
    return type(out)(*(None if t is None else t.clone() for t in out))


class Program:
    """One captured program: its graph, input buffers, generators, outputs,
    what one replay counts and, captured with the tracer on, its stage
    marks (utils/profiling.py)."""

    def __init__(self, device: torch.device, n_sources: int, pool=None,
                 stream=None):
        self.device = device
        self.pool, self.stream = pool, stream
        self.gens = [torch.Generator(device=device) for _ in range(n_sources)]
        self.graph = None
        self.replays = 0          # replays run, the capture's first included
        self.record = Counter()   # what one replay counts (profiling.recording)
        self.marks: list = []     # (stage, event) recorded into the graph
        self._nodes = None

    def _seed(self, seeds) -> None:
        for g, s in zip(self.gens, seeds):
            g.manual_seed(int(s))

    def __call__(self, fn, seeds, inputs, static: dict):
        with profiling.span("program.call"):
            if self.device.type != "cuda":
                self._seed(seeds)
                return fn(rng.Stack(self.gens), *(
                    torch.as_tensor(x, dtype=torch.float32, device=self.device)
                    for x in inputs), **static)
            tracer = profiling.active()
            if tracer is not None:
                tracer.read_replay(self.marks)
            fresh = self.graph is None
            if fresh:
                with profiling.span("program.capture"):
                    self._seed(seeds)
                    self._capture(fn, inputs, static)
            with profiling.span("program.inputs"):
                if not fresh:
                    for buf, x in zip(self.bufs, inputs):
                        buf.copy_(torch.as_tensor(x))
                self._seed(seeds)
            with profiling.span("program.replay"):
                self.graph.replay()
            profiling.recount(self.record)
            self.replays += 1
            with profiling.span("program.outputs"):
                out = _clone(self.out)
            if tracer is not None:
                tracer.replayed(self.marks, self.nodes()["kernel"])
            return out

    def _capture(self, fn, inputs, static: dict) -> None:
        dev = self.device
        self.bufs = [torch.empty(tuple(np.shape(x)), dtype=torch.float32, device=dev)
                     for x in inputs]
        for buf, x in zip(self.bufs, inputs):
            buf.copy_(torch.as_tensor(x))
        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream), profiling.quiet():
            fn(rng.Stack(self.gens), *self.bufs, **static)           # warm-up
        # the graph is kept beside its instance, for `nodes`
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for g in self.gens:
            graph.register_generator_state(g)
        with (profiling.recording() as self.record, profiling.capturing(self.marks),
              torch.cuda.graph(graph, pool=self.pool, stream=self.stream)):
            self.out = fn(rng.Stack(self.gens), *self.bufs, **static)
        graph.instantiate()
        self.graph = graph
        profiling.count("program.captures")

    def nodes(self) -> Counter:
        """The captured graph's nodes by type (`kernel`, `event_record`,
        ...; utils/profiling.graph_nodes), counted once."""
        if self._nodes is None:
            self._nodes = profiling.graph_nodes(self.graph.raw_cuda_graph())
        return self._nodes


class Programs:
    """A cache from a static key to one `Program`, for one owner (an
    estimator or a library sweep), and the memory pool and capture stream
    its programs share; the programs and the pool go with the owner."""

    def __init__(self):
        self.programs: dict = {}
        self.pool = self.stream = None

    def __len__(self) -> int:
        return len(self.programs)

    @staticmethod
    def key(seeds, inputs, device: torch.device, static: dict) -> tuple:
        """The static arguments (arrays as tuples), the inputs' shapes, the
        number of seeds and the device."""
        stat = tuple(sorted(
            (k, tuple(np.ravel(v).tolist()) if isinstance(v, np.ndarray) else v)
            for k, v in static.items()))
        shapes = tuple(tuple(np.shape(x)) for x in inputs)
        return stat, shapes, len(seeds), device

    def __call__(self, fn, seeds, inputs, device, **static):
        """fn's outputs for `seeds` (one int per generator) and `inputs`,
        through the program of this key (captured at its first call)."""
        device = torch.device(device)
        key = self.key(seeds, inputs, device, static)
        prog = self.programs.get(key)
        if prog is None:
            if device.type == "cuda" and self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self.stream = torch.cuda.Stream(device)
            prog = self.programs[key] = Program(device, len(seeds), self.pool,
                                                self.stream)
        return prog(fn, seeds, inputs, static)

    def pool_bytes(self) -> int:
        """The bytes of the device segments in the programs' memory pool."""
        if self.pool is None:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) == pool)
