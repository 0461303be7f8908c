"""Tracing and profiling utilities (counterpart of utils/profiling.py).

  - `PhaseTimer`: wall-clock phase accounting that waits for the card at
    the end of a phase (`sync`), so a phase's time includes the device work
    it queued.
  - `trace`: a torch.profiler context (host, and the card when one is in
    use) that writes a Chrome trace, with the tracer on; the command
    line's `--profile`.
  - `profile_counts`: one call under torch.profiler, reduced to its wall ms,
    the device ms of its kernels and its ATen operator calls. It takes the
    place of the reference's `hlo_cost` (XLA's cost analysis has no
    counterpart here): the numbers `PERF.md` reads per layer.
  - The tracer, one per process (`TRACER`), off by default and switched by
    `tracing(True)` before an owner's first capture. It keeps
      * host spans (`span`): name, start and end on `time.perf_counter`,
        the parent span and the frame (`Tracker.step` and
        `LibrarySweep.step` open one). While a profiler records, each is
        also a `record_function` range named `PREFIX + name`;
      * device stages (`stage`, `stage_end`): the frame program's five
        `STAGES`, in order, marked inside the traced functions. In a
        capture a mark is an external timing event, an event-record node
        of the graph, and each replay's stage times are read before the
        program's next replay or at `snapshot`. A warm-up marks nothing;
        an eager call marks events on the card, the host clock on the CPU;
      * counters (`count`), among them those counted inside a traced
        function (the scorer's particles by scoring tier:
        `score.points.coarse` and `.full` in point mode,
        `score.renders.coarse` and `.full` in pixel mode), and counts of
        a device value's changes from call to call (`count_changes`: a
        shared-scene library's named candidate), compared at the snapshot
        so that no call reads the card; and on the card
        each program call's device interval (timing events around its
        input copies, replay and output clones), put on the host clock by
        an anchor event at `reset`: the card's idle gaps named by the host
        span the card went idle in, and split over the spans the host
        passed through meanwhile, without a profiler.
    `snapshot` reduces them to per-frame readings. Off, every site is one
    flag test: no event is recorded and no graph gains a node.
  - One store for the kernels' launches (`launched`: always, never
    cleared) and the tracer's counters (while it is on, until `reset`). A
    capture runs nothing: what it counted comes back out (`recording`) and
    is counted once per replay (`recount`).

torch.profiler loses events of kernels that take a few microseconds, so
`device_ms` is a lower bound of the card's busy time.
"""
from __future__ import annotations

import bisect
import contextlib
import ctypes
import functools
import os
import time
from collections import Counter, defaultdict

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
    log_dir/trace.json (Chrome trace format), with the tracer on: the trace
    names the host spans (`PREFIX`), and the programs captured inside carry
    the stage marks."""
    from torch.profiler import profile

    os.makedirs(log_dir, exist_ok=True)
    was_on = tracing(True)
    try:
        with profile(activities=_activities(device)) as prof:
            yield prof
    finally:
        tracing(was_on)
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


# -- the tracer ---------------------------------------------------------------

PREFIX = "pose."        # the host spans' record_function names
STAGES = ("prep", "seed", "scan", "polish", "finish")   # the frame program's
OUTSIDE = "outside"     # an idle gap that no span was open over

_ON = False
_NULL = contextlib.nullcontext()
_EAGER = object()       # the tracer's mode outside a capture and its warm-up


def tracing(on: bool | None = None) -> bool:
    """Turns the tracer on (True) or off (False), or leaves it (None);
    returns whether it was on. A program captured while it is on carries
    the stage marks: turn it on before an owner's first capture (the
    programs' keys do not hold it)."""
    global _ON
    was = _ON
    if on is not None:
        _ON = bool(on)
    return was


def span(name: str, frame: bool = False):
    """A host span around a `with` block; `frame` opens a new frame."""
    if not _ON:
        return _NULL
    return _Span(TRACER, name, frame)


# The counts: a kernel launch under (kernel, shape), a tracer counter under
# its name (a str)
_COUNTS: Counter = Counter()


def count(name: str, n: int = 1) -> None:
    """Adds `n` to the counter `name`."""
    if _ON:
        _COUNTS[name] += n


def count_changes(name: str, value: torch.Tensor) -> None:
    """Counts under `name` the calls whose `value` (a device scalar)
    differs from the call before's; read at the snapshot, so no call reads
    the card."""
    if _ON:
        TRACER.choices[name].append(value.detach().reshape(1))


def launched(kernel: str, shape: tuple) -> None:
    """Counts one launch of `kernel` at `shape`, the tracer on or off."""
    _COUNTS[kernel, shape] += 1


def launches() -> Counter:
    """The launches counted in the process, {(kernel, shape): launches}."""
    return Counter({k: n for k, n in _COUNTS.items() if type(k) is tuple})


@contextlib.contextmanager
def recording():
    """Around a CUDA graph's capture, which runs nothing: yields a record
    that at the end holds what was counted inside, taken back out of the
    counts."""
    global _COUNTS
    before, record = Counter(_COUNTS), Counter()
    try:
        yield record
    finally:
        record.update(_COUNTS - before)
        _COUNTS -= record     # in place, dropping the keys it leaves at 0


def recount(record: Counter) -> None:
    """Counts `record` (a `recording`'s) again, as one replay of its graph:
    its launches, and its tracer counters while the tracer is on."""
    if _ON:
        _COUNTS.update(record)
    else:
        _COUNTS.update({k: n for k, n in record.items() if type(k) is tuple})


def stage(name: str, device) -> None:
    """Marks the start of device stage `name` (one of STAGES), which ends
    the stage before it, on `device`'s current stream."""
    if _ON:
        TRACER.mark(name, device)


def stage_end(device) -> None:
    """Marks the end of the last stage."""
    if _ON:
        TRACER.mark(None, device)


def quiet():
    """A capture's warm-up: no stage is marked inside."""
    if not _ON:
        return _NULL
    return TRACER.mode(None)


def capturing(marks: list):
    """A capture: inside, each stage mark is an external timing event
    recorded into the graph (an event-record node), appended to `marks`
    as (stage, event); the program owns them."""
    if not _ON:
        return _NULL
    return TRACER.mode(marks)


def device_call(device):
    """Around a call into the card's programs (`Estimator.estimate`,
    `LibrarySweep._run`): its device interval, timing events at its start
    and end on the card, as the benchmark's events bracket the same calls."""
    if not _ON or torch.device(device).type != "cuda":
        return _NULL
    return _DeviceCall(TRACER)


def active():
    """The tracer if it is on, else None."""
    return TRACER if _ON else None


def reset() -> None:
    """Clears the tracer's spans, stages, counters and device intervals
    (not the launch counts); on the card, anchors the card's clock to the
    host's."""
    TRACER.reset()


def snapshot(t_end: float | None = None) -> dict:
    """The tracer's readings since the reset, up to `t_end` (the host
    clock; now if None): `Tracer.snapshot`."""
    return TRACER.snapshot(t_end)


@functools.cache
def _graph_api():
    """The CUDA driver's cuGraphGetNodes and cuGraphNodeGetType, bound
    with ctypes (a runtime cudaGraph_t is a driver CUgraph)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    return lib.cuGraphGetNodes, lib.cuGraphNodeGetType


# CUgraphNodeType values (cuda.h) -> names
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record", 10: "mem_alloc",
              11: "mem_free"}


def graph_nodes(raw_graph: int) -> Counter:
    """The nodes of a captured graph (`CUDAGraph.raw_cuda_graph()`, which
    needs `keep_graph=True`) by type: `kernel`, `event_record`, ..."""
    get_nodes, get_type = _graph_api()
    n = ctypes.c_size_t(0)
    if get_nodes(raw_graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and get_nodes(raw_graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    out, kind = Counter(), ctypes.c_int(0)
    for node in nodes:
        if get_type(node, ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        out[NODE_TYPES.get(kind.value, f"type{kind.value}")] += 1
    return out


class _Span:
    """An open host span (`span`)."""

    __slots__ = ("tracer", "name", "frame", "gen", "index", "rf")

    def __init__(self, tracer, name: str, frame: bool):
        self.tracer, self.name, self.frame = tracer, name, frame

    def __enter__(self):
        t = self.tracer
        if self.frame:
            t.frames += 1
        self.gen, self.index = t.gen, len(t.spans)
        t.spans.append([self.name, t.clock(), None,
                        t.stack[-1] if t.stack else -1, t.frames])
        t.stack.append(self.index)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t = self.tracer
        if t.gen == self.gen:   # else a reset cleared the span
            t.spans[self.index][2] = t.clock()
            t.stack.pop()
        return False


class _DeviceCall:
    """An open call into the card's programs (`device_call`)."""

    __slots__ = ("tracer", "start")

    def __init__(self, tracer):
        self.tracer = tracer

    def __enter__(self):
        if self.tracer.anchor is None:
            self.tracer._anchor()
        self.start = torch.cuda.Event(enable_timing=True)
        self.start.record()
        return self

    def __exit__(self, *exc):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self.tracer.calls.append((self.start, end))
        return False


class Tracer:
    """The process's host spans, device stages, counters and program
    calls' device intervals, since the last `reset`."""

    def __init__(self, clock=time.perf_counter):
        self.clock = clock
        self.gen = 0
        self._mode = _EAGER
        self.last_choice: dict = {}   # count_changes' last value read, by name
        self.reset()

    def reset(self) -> None:
        self.gen += 1
        self.spans: list = []     # [name, start, end, parent index (-1), frame]
        self.stack: list = []     # the open spans' indices
        self.frames = 0           # frames opened (the current frame's id)
        for name in [k for k in _COUNTS if type(k) is str]:
            del _COUNTS[name]
        self.stage_ms = dict.fromkeys(STAGES, 0.0)
        self.choices = defaultdict(list)   # count_changes' values not read
        self.runs: list = []      # (frame, its stages in order) of each run read
        self.unread: dict = {}    # id(marks) -> (marks, frame): replays not read
        self.eager: list = []     # (marks, frame): eager runs on the card not read
        self._marks = None        # the eager run being marked
        self.calls: list = []     # (start, end) events of the program calls
        self.anchor = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            self._anchor()
        self.t_reset = self.clock()

    @property
    def counters(self) -> Counter:
        """The tracer's counters since the reset (a copy)."""
        return Counter({k: n for k, n in _COUNTS.items() if type(k) is str})

    def _anchor(self) -> None:
        """An event on the card and the host clock read once it is done:
        the card's events on the host clock."""
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        ev.synchronize()
        self.anchor, self.t_anchor = ev, self.clock()

    @contextlib.contextmanager
    def mode(self, marks):
        prev, self._mode = self._mode, marks
        try:
            yield
        finally:
            self._mode = prev

    # -- device stages ------------------------------------------------------

    def mark(self, name, device) -> None:
        m = self._mode
        if m is None:                       # a warm-up
            return
        if m is not _EAGER:                 # a capture
            ev = torch.cuda.Event(enable_timing=True, external=True)
            ev.record()
            m.append((name, ev))
            return
        dev = torch.device(device)
        if dev.type == "cuda":
            value = torch.cuda.Event(enable_timing=True)
            value.record(torch.cuda.current_stream(dev))
        else:
            value = self.clock()
        if name == STAGES[0]:
            self._marks = []
        if self._marks is None:             # outside a marked run
            return
        self._marks.append((name, value))
        if name is None:
            marks, self._marks = self._marks, None
            if dev.type == "cuda":
                self.eager.append((marks, self.frames))
            else:
                self._read(marks, self.frames)

    def _read(self, marks, frame) -> None:
        """Adds a run's stage times: marks [(stage or None, event or host
        time)], each stage running to the next mark."""
        for (name, a), (_, b) in zip(marks, marks[1:]):
            self.stage_ms[name] += (a.elapsed_time(b) if isinstance(a, torch.cuda.Event)
                                    else 1e3 * (b - a))
        self.runs.append((frame, tuple(name for name, _ in marks[:-1])))

    def read_replay(self, marks) -> None:
        """The stage times of the last replay of the program that owns
        `marks`, if not read yet: before its next replay overwrites them."""
        got = self.unread.pop(id(marks), None)
        if got is not None:
            got[0][-1][1].synchronize()
            self._read(*got)

    def replayed(self, marks, kernels: int) -> None:
        """After a replay: counts it and its kernel nodes, and leaves its
        stages to read."""
        _COUNTS["program.replays"] += 1
        _COUNTS["program.kernels"] += kernels
        if marks:
            self.unread[id(marks)] = (marks, self.frames)

    # -- readings -----------------------------------------------------------

    def span_totals(self, t_end: float | None = None) -> dict:
        """Per span name: `total_s`, `self_s` (less the direct children's
        time) and `count`; a span still open runs to `t_end` (now)."""
        t_end = self.clock() if t_end is None else t_end
        dur = [(e if e is not None else t_end) - s for _, s, e, _, _ in self.spans]
        child = [0.0] * len(self.spans)
        for d, (_, _, _, parent, _) in zip(dur, self.spans):
            if parent >= 0:
                child[parent] += d
        out: dict = {}
        for (name, *_), d, c in zip(self.spans, dur, child):
            o = out.setdefault(name, {"total_s": 0.0, "self_s": 0.0, "count": 0})
            o["total_s"] += d
            o["self_s"] += d - c
            o["count"] += 1
        return out

    def open_at(self, t: float) -> str:
        """The innermost span open at host time `t`, or OUTSIDE. Spans nest,
        so those open at `t` are the last span started by `t` and its
        ancestors."""
        i = bisect.bisect_right(self.spans, t, key=lambda sp: sp[1]) - 1
        while i >= 0:
            name, _, end, parent, _ = self.spans[i]
            if end is None or end > t:
                return name
            i = parent
        return OUTSIDE

    def gaps(self, t_end: float) -> list | None:
        """The card's idle gaps (host clock) between the reset and `t_end`:
        outside every program call's device interval. None without program
        calls on the card."""
        if self.anchor is None or not self.calls:
            return None
        a, t0 = self.anchor, self.t_anchor
        busy = sorted((t0 + 1e-3 * a.elapsed_time(s), t0 + 1e-3 * a.elapsed_time(e))
                      for s, e in self.calls)
        out, idle_from = [], self.t_reset
        for s, e in busy + [(t_end, t_end)]:
            if s > idle_from:
                out.append((idle_from, min(s, t_end)))
            idle_from = max(idle_from, e)
            if idle_from >= t_end:
                break
        return out

    def idle(self, gaps: list) -> tuple[dict, dict]:
        """The idle seconds of `gaps` by the innermost span open when the
        card went idle (`portbench/trace.py`'s rule), and split over the
        innermost spans the host passed through while it was idle."""
        at_start: dict = defaultdict(float)
        split: dict = defaultdict(float)
        edges = sorted(t for _, s, e, _, _ in self.spans
                       for t in (s, e) if t is not None)
        for g0, g1 in gaps:
            at_start[self.open_at(g0)] += g1 - g0
            lo, hi = bisect.bisect_right(edges, g0), bisect.bisect_left(edges, g1)
            cuts = [g0, *edges[lo:hi], g1]
            for c0, c1 in zip(cuts, cuts[1:]):
                if c1 > c0:
                    split[self.open_at(0.5 * (c0 + c1))] += c1 - c0
        return dict(at_start), dict(split)

    def _read_choices(self) -> None:
        """`count_changes`' values into their counters: each against the
        one before, the first against the last read (across a reset)."""
        for name, values in self.choices.items():
            if not values:
                continue
            seq = torch.cat(([self.last_choice[name]] if name in self.last_choice
                             else []) + values)
            _COUNTS[name] += int((seq[1:] != seq[:-1]).sum())
            self.last_choice[name] = seq[-1:]
        self.choices.clear()

    def snapshot(self, t_end: float | None = None) -> dict:
        """The readings since the reset, up to `t_end` (now): the frames,
        span totals, counters, stage ms (the replays' read first; waits for
        the card), the runs' stage order, the card's idle seconds by the span
        open when it went idle (`idle_s`) and split over the spans the host
        passed through meanwhile (`idle_split_s`; both None without program
        calls on the card) and `per_frame`, each reading per frame:

          - `<stage>_ms` for each of STAGES (absent if no run was marked);
          - `kernels_per_frame`: kernel nodes replayed (absent without a
            replay);
          - `coarse_points_per_frame`, `full_points_per_frame`: the
            point-mode scorer's particles by tier, and
            `coarse_renders_per_frame`, `full_renders_per_frame`: the
            pixel-mode scorer's particle renders (each absent without
            one);
          - `launch_ms`: host ms in `program.replay` (absent without one);
          - `init_step_share`: % of frames that ran the init program;
          - `wasted_slot_share`: % of the object-slots the programs ran
            that went to the init program for an object that did not need
            it (0 when no init ran);
          - `identify_change_share`: % of a shared-scene library's steps
            whose named candidate differs from the step before's (absent
            without such a step);
          - `idle_ms`: the card's idle ms (absent without program calls on
            the card).

        `per_frame` is empty before the first frame."""
        t_end = self.clock() if t_end is None else t_end
        if self.calls or self.unread or self.eager:
            torch.cuda.synchronize()
        for got in list(self.unread.values()) + self.eager:
            self._read(*got)
        self.unread.clear()
        self.eager.clear()
        self._read_choices()
        spans = self.span_totals(t_end)
        gaps = self.gaps(t_end)
        idle, idle_split = self.idle(gaps) if gaps is not None else (None, None)
        c, f = self.counters, self.frames
        per: dict = {}
        if f:
            if self.runs:
                per.update({f"{s}_ms": self.stage_ms[s] / f for s in STAGES})
            if "program.kernels" in c:
                per["kernels_per_frame"] = c["program.kernels"] / f
            for tier in ("coarse", "full"):
                for what in ("points", "renders"):
                    if f"score.{what}.{tier}" in c:
                        per[f"{tier}_{what}_per_frame"] = c[f"score.{what}.{tier}"] / f
            if "program.replay" in spans:
                per["launch_ms"] = 1e3 * spans["program.replay"]["total_s"] / f
            per["init_step_share"] = 100.0 * c["init.steps"] / f
            slots = c["slots.init"] + c["slots.track"]
            per["wasted_slot_share"] = (
                100.0 * (c["slots.init"] - c["init.needed"]) / slots if slots else 0.0)
            if c["identify.steps"]:
                per["identify_change_share"] = (100.0 * c["identify.changes"]
                                                / c["identify.steps"])
            if idle is not None:
                per["idle_ms"] = 1e3 * sum(idle.values()) / f
        return {"frames": f, "seconds": t_end - self.t_reset, "spans": spans,
                "counters": dict(c), "stage_ms": dict(self.stage_ms),
                "runs": list(self.runs), "idle_s": idle, "idle_split_s": idle_split,
                "per_frame": per}


TRACER = Tracer()
