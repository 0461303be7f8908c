"""Tracing and profiling utilities (counterpart of utils/profiling.py).

  - `PhaseTimer`: wall-clock phase accounting that waits for the card at
    the end of a phase (`sync`), so a phase's time includes the device work
    it queued.
  - `trace`: a torch.profiler context (host, and the card when one is in
    use) that writes a Chrome trace; the command line's `--profile`.
  - `profile_counts`: one call under torch.profiler, reduced to its wall ms,
    the device ms of its kernels and its ATen operator calls. It takes the
    place of the reference's `hlo_cost` (XLA's cost analysis has no
    counterpart here): the numbers `PERF.md` reads per layer.

torch.profiler loses events of kernels that take a few microseconds, so
`device_ms` is a lower bound of the card's busy time.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class PhaseTimer:
    """Accumulating wall-clock timer with device-sync-on-stop."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        """Time a phase; pass the phase's output tensor (or a tuple holding
        one) as `sync_on`, or call .sync(x) before exit, to wait for the
        card."""
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            if sync_on is not None:
                self.sync(sync_on)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    @staticmethod
    def sync(x) -> None:
        """Wait for the device of the first CUDA tensor in `x` (a tensor, or
        a tuple, list or dict of them, nested); nothing on the CPU."""
        for leaf in _leaves(x):
            if leaf.is_cuda:
                torch.cuda.synchronize(leaf.device)
                return

    def report(self) -> str:
        total = sum(self.totals.values())
        lines = [f"{'phase':<28}{'total_s':>9}{'calls':>7}{'ms/call':>9}{'%':>6}"]
        for name, t in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name:<28}{t:>9.3f}{n:>7}{t / n * 1000:>9.1f}"
                f"{100 * t / max(total, 1e-9):>6.1f}"
            )
        return "\n".join(lines)


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)


def _activities(device) -> list:
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str, device="cuda"):
    """torch.profiler trace of everything inside the context, written to
    log_dir/trace.json (Chrome trace format)."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities(device)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def profile_counts(fn, *args, device="cuda", **kwargs) -> dict:
    """fn(*args, **kwargs) once under torch.profiler. Returns `wall_ms`
    (host clock around the call and a wait for the card), `device_ms` (the
    self time of every kernel the profiler recorded: a lower bound, it loses
    events of few-microsecond kernels; 0 on the CPU), `aten_calls` (ATen
    operator calls, every level of nesting) and `result` (what fn
    returned)."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    with profile(activities=_activities(dev)) as prof:
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall_ms = 1000.0 * (time.perf_counter() - t0)
    events = prof.key_averages()
    device_ms = sum(e.self_device_time_total for e in events
                    if e.device_type == DeviceType.CUDA
                    and not getattr(e, "is_user_annotation", False)) / 1000.0
    aten_calls = sum(e.count for e in events if e.key.startswith("aten::"))
    return dict(wall_ms=wall_ms, device_ms=device_ms, aten_calls=aten_calls,
                events=events, result=result)
