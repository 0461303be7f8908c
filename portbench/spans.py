"""The benchmark's own readings around the calls into the program's layers.

Host spans are off unless a run is traced; while a profiler records, each
span is also a `record_function` range, so the trace's idle gaps can be
named by the span the host was in. On the card, every call into a program
is also bracketed by two CUDA events on the current stream, which time the
card's work in the program frame by frame without a profiler: the set-up
waits on them for the card to settle (harness.py), and the traced run's
idle share divides their sum by the window."""
from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext


class Spans:
    def __init__(self, on: bool = False, events: bool = False):
        self.on = on
        self.events = events
        self.profiling = False
        self.seconds: dict = defaultdict(float)   # name -> total seconds
        self.frames: list = []                    # per frame, its calls' event pairs

    def reset(self) -> None:
        self.seconds.clear()
        self.frames.clear()

    def new_frame(self) -> None:
        self.frames.append([])

    @contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(f"portbench.{name}")
        else:
            rf = nullcontext()
        t0 = time.perf_counter()
        with rf:
            try:
                yield
            finally:
                self.seconds[name] += time.perf_counter() - t0

    def instrument(self, owner, attr: str, name: str) -> None:
        """Wrap `owner.attr` (a bound method, a call into a program) in the
        span `name` and, on the card, in a pair of CUDA events; on this
        instance only."""
        fn = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            with self.span(name):
                if not self.events:
                    return fn(*args, **kwargs)
                import torch
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
                if self.frames:
                    self.frames[-1].append((start, end))
                return out

        setattr(owner, attr, wrapped)

    def frame_ms(self, k: int) -> float:
        """Frame k's card time in the program calls, ms (waits for them)."""
        return sum(s.elapsed_time(e) for s, e in self.frames[k])

    def device_ms(self) -> list:
        """Every recorded frame's card time in the program calls, ms."""
        import torch

        torch.cuda.synchronize()
        return [self.frame_ms(k) for k in range(len(self.frames))]
