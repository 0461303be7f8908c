"""One run of one cell: inputs from the seed, the program's set-up, the
measured window, the traced stretch, the comparison, the result line.

A cell is `workloads/<name>.json` (its configuration, its traffic mix, the
end-to-end metrics it reports and the limits of the numbers compared); the configuration is
`configs/<name>.json`, the mix `traffic/<name>.json`, the driver of its
entry `loops/<loop>.py`, each per-layer metric `metrics/<name>.py` and
each kernel's yardstick `kernels/<wrapper>.py`, all found by name.

The window is closed-loop: a frame is handed over only once the last
frame's poses are on the host. It runs until `seconds` have passed and
ends with the frame in flight. A frame's latency runs from the hand-over
to its poses on the host. With `trace`, the window also keeps the
benchmark's host spans; after it, a few more frames are profiled.

Before the window, set-up serves warm frames until the card has settled
(`settle`): the card runs a freshly captured program in a slow state for
a stretch of seconds that differs from process to process (PERF.md), so
the window starts once the card's time in the program, read from CUDA
events, is within `SETTLE_TOL` of the fastest this checkout has recorded
for the cell, or after `SETTLE_CAP_S`."""
from __future__ import annotations

import gc
import json
import math
import sys
import time
from pathlib import Path

import numpy as np

from . import generator, kernels, loops, metrics, trace
from .reference import checks
from .spans import Spans


def p95(values) -> float:
    """The 95th percentile of every frame's latency (linear between order
    statistics)."""
    return float(np.percentile(np.asarray(values, np.float64), 95))

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "icra20_hand_object_pose_tpu")
PROFILED_FRAMES = 2
SETTLE_MIN_S = 10.0    # the shortest wait, so that set-up takes the same time
SETTLE_CAP_S = 60.0    # the longest wait for the card to settle
SETTLE_FIRST_CAP_S = 30.0   # the longest in a checkout's first run
SETTLE_TOL = 0.04      # settled: within 4% of the fastest recorded
SETTLE_FRAMES = 5      # frames whose median is compared
SETTLE_DIR = ROOT.parent / ".portbench_cache" / "settle"


def load_json(kind: str, name: str) -> dict:
    path = ROOT / kind / f"{name}.json"
    if not path.is_file():
        raise SystemExit(f"portbench: no {kind} named {name!r} ({path.name})")
    return json.loads(path.read_text())


def load_cell(name: str) -> tuple[dict, dict, dict]:
    cell = load_json("workloads", name)
    return cell, load_json("configs", cell["config"]), load_json("traffic", cell["traffic"])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: needs {n} CUDA device(s), found {count}", file=sys.stderr)
        raise SystemExit(2)


def device_info(device, peak: int) -> dict:
    import subprocess

    import torch

    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30).stdout.split()
        info["power_limit_w"] = float(out[0])
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        pass
    return info


def window(serve, first: int, seconds: float, n_objects: int) -> dict:
    """Serve frames from `first` until `seconds` have passed."""
    lat, served, failed = [], [], 0
    i = first
    w0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        try:
            s = serve(i)
        except Exception as exc:   # the program failed this frame: count it
            print(f"portbench: frame {i} raised {type(exc).__name__}: {exc}",
                  file=sys.stderr)
            s = None
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        served.append(s)
        failed += n_objects if s is None else int(
            (~np.isfinite(s.poses.reshape(n_objects, -1)).all(axis=1)).sum())
        i += 1
        if t1 - w0 >= seconds:
            break
    return {"latency": lat, "served": served, "failed": failed, "next": i,
            "seconds": t1 - w0}


def _settle_path(cell_name: str) -> Path:
    return SETTLE_DIR / f"{cell_name}.json"


def settle(serve, first: int, spans, cell_name: str) -> tuple[int, float]:
    """Serve warm frames from `first` for SETTLE_MIN_S, then until the
    card's time in the program (the median of the last SETTLE_FRAMES
    frames) is within SETTLE_TOL of the fastest this checkout has recorded
    for the cell, or, with no record yet (a checkout's first run), has
    fallen by 1.5 x SETTLE_TOL from the first frames' (the slow state has
    ended); at most SETTLE_CAP_S (SETTLE_FIRST_CAP_S without a record).
    The floor keeps set-up's length steady: most slow stretches end within
    it. Returns the next frame and the seconds waited."""
    path = _settle_path(cell_name)
    fastest = json.loads(path.read_text())["program_ms"] if path.is_file() else None
    cap = SETTLE_CAP_S if fastest is not None else SETTLE_FIRST_CAP_S
    t0 = time.perf_counter()
    ms, i = [], first
    while True:
        serve(i)
        i += 1
        ms.append(spans.frame_ms(len(spans.frames) - 1))
        waited = time.perf_counter() - t0
        if waited >= cap:
            break
        if waited < SETTLE_MIN_S or len(ms) < SETTLE_FRAMES:
            continue
        last = float(np.median(ms[-SETTLE_FRAMES:]))
        if fastest is not None:
            if last <= (1.0 + SETTLE_TOL) * fastest:
                break
        elif last <= (1.0 - 1.5 * SETTLE_TOL) * float(np.median(ms[:SETTLE_FRAMES])):
            break
    print(f"portbench: settled in {waited:.3f} s, {len(ms)} frames on the card at "
          f"{ms[0]:.3f} ms first and {ms[-1]:.3f} ms last (fastest recorded: "
          f"{fastest})", file=sys.stderr)
    return i, waited


def record_settled(cell_name: str, program_ms: list) -> None:
    """Keep the fastest card time a frame of this cell has taken in this
    checkout: the tenth percentile of the window's frames, if below the
    record."""
    if len(program_ms) < 10:
        return
    low = float(np.percentile(program_ms, 10))
    path = _settle_path(cell_name)
    if path.is_file() and json.loads(path.read_text())["program_ms"] <= low:
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"program_ms": low}))
    tmp.replace(path)


def _host(x, n_objects: int) -> np.ndarray:
    return (x.detach().cpu().numpy() if hasattr(x, "detach")
            else np.asarray(x)).reshape(n_objects)


def run(cell_name: str, seed: int, seconds: float, traced: bool, *,
        t_start: float, device: str = "cuda", cell=None, fault=None) -> dict:
    """One run; returns the result line's object (its `compared` last).
    `cell` replaces the cell's files (cell, config, mix), `fault` breaks the
    entry underneath (faults.py): both are for the checks of the
    comparison, never for a benchmark run."""
    import torch

    spec, config, mix = cell or load_cell(cell_name)
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        require_cards(int(spec.get("chips", 1)))
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    torch.set_num_threads(4)
    traffic = generator.make(config, mix, seed, device)
    O = len(traffic.kinds)
    spans = Spans(on=traced, events=on_card)
    loop = loops.load(traffic.loop).Loop(config, traffic, seed, device, spans)
    if fault is not None:
        fault(loop)

    def serve(i: int):
        spans.new_frame()
        return loop.serve(i)

    for i in range(traffic.setup_frames):
        serve(i)
    first, settle_s = traffic.setup_frames, 0.0
    if on_card:
        first, settle_s = settle(serve, first, spans, cell_name)
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    spans.reset()
    w = window(serve, first, seconds, O)
    n = len(w["served"])
    frame_ms = 1e3 * w["seconds"] / n
    program_ms = spans.device_ms() if on_card else []
    if on_card and fault is None:
        record_settled(cell_name, program_ms)
    ok = [s for s in w["served"] if s is not None]
    reinit = np.concatenate([_host(s.reinitialized, O) for s in ok]) if ok else np.zeros(0)
    breakdown, traced_dev = None, {}
    if traced:
        readings = metrics.Readings(
            config=config, frames=n,
            window_s=w["seconds"], latency_s=list(w["latency"]),
            spans=dict(spans.seconds), program_ms=program_ms, settle_s=settle_s,
            init_object_frames=int(reinit.sum()),
            track_object_frames=int(len(reinit) - reinit.sum()))
        if on_card:
            readings.trace = trace.profile(serve, w["next"], PROFILED_FRAMES,
                                           spans, kernels.load_all())
            t = readings.trace
            traced_dev = {"busy_s": t["busy_s"], "window_s": t["window_s"]}
            breakdown = {"device_ops": [[k, v] for k, v in t["device_ops"]],
                         "idle_gaps": [[k, v] for k, v in t["idle_gaps"]]}
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # the judged outputs to the host, then the program's state freed
    poses = np.stack([s.poses if s is not None else np.full((O, 4, 4), np.nan)
                      for s in w["served"]])
    fitness = np.stack([_host(s.fitness, O) if s is not None else np.full(O, np.nan)
                        for s in w["served"]])
    coverage = np.stack([_host(s.coverage, O) if s is not None else np.full(O, np.nan)
                         for s in w["served"]])
    frames = np.asarray([traffic.index(i) for i in range(first, w["next"])])
    del loop, ok, w["served"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = checks.judge(
        poses.reshape(-1, 4, 4), traffic.pose_gt[frames].reshape(-1, 4, 4),
        np.tile(np.arange(O), n), fitness.reshape(-1), coverage.reshape(-1),
        traffic.meshes, device)
    limits = spec["limits"]
    compared = {k: {"value": v, "limit": limits[k]}
                for k, v in verdict["compared"].items()}
    correct = w["failed"] == 0 and all(c["value"] <= c["limit"] for c in compared.values())
    if traced:
        mods = metrics.load_all()
        values = {name: mods[name].read(readings) for name in sorted(mods)}
        out_metrics = {name: {"value": v, "unit": mods[name].UNIT}
                       for name, v in values.items() if v is not None}
    else:
        e2e = {
            "setup_s": {"value": setup_s, "unit": "s"},
            "frame_ms": {"value": frame_ms, "unit": "ms"},
            "frame_ms_p95": {"value": 1e3 * p95(w["latency"]), "unit": "ms"},
            "adds_mm": {"value": verdict["compared"]["adds_mm"], "unit": "mm"},
        }
        out_metrics = {name: e2e[name] for name in spec["end_to_end"]}
    result = {"correct": bool(correct), "attempted": n * O, "failed": int(w["failed"]),
              "metrics": out_metrics,
              "device": ({**device_info(device, peak), **traced_dev} if on_card
                         else {"platform": "cpu", "kind": "cpu", "count": 0,
                               "memory_peak_bytes": 0})}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = compared
    return result


def emit(result: dict) -> int:
    """The compared numbers on standard error, the result as the last line
    of standard output; or no result, and a non-zero code, if JAX or the
    JAX package was loaded in this process."""
    found = forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


def main(argv=None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    result = run(a.workload, a.seed, a.seconds, bool(a.trace), t_start=t_start)
    for c in result["compared"].values():
        if not math.isfinite(c["value"]):
            c["value"] = 1e300   # inf has no JSON form: the largest double stands in
    return emit(result)
