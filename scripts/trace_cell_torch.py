"""Trace a cell of the benchmark with the port's own tracer
(icra20_hand_object_pose_tpu_torch/utils/profiling.py):

    python3 scripts/trace_cell_torch.py --workload track.t42_box_vga --seed 7 \
        --seconds 20 [--tracing 0]

A cell runs as `portbench/run.py` runs it: its inputs from the seed, its
loop, set-up until the card has settled (`portbench.harness.settle`), then
a closed-loop window. The tracer is turned on before the loop is built, so
the programs' graphs carry the stage marks; it is reset at the window's
start and read right after it, beside the benchmark's own CUDA events
around each program call (`portbench/spans.py`). Prints one JSON line:
`frame_ms`, `program_ms` (the benchmark's card ms per frame in the program
calls) and `device_idle_share`, the tracer's per-frame readings
(`per_frame`: the five stages, `kernels_per_frame`, `launch_ms`,
`init_step_share`, `wasted_slot_share`, in a library identification cell
`identify_change_share` (% of steps whose named candidate changed),
`idle_ms`, and the scorer's
particles by tier: in point mode `coarse_points_per_frame` and
`full_points_per_frame`, in pixel mode `coarse_renders_per_frame` and
`full_renders_per_frame`), the kernels' launches in the window per frame
by wrapper and by shape (`launches`; K5's shape is (P, Nr, H, W), K6's
(P, N, H, W, rule, subpixel)), the
stages' sum over
`program_ms`, the idle by span (ms per frame; by the span open when the
card went idle, and split over the spans the host passed through) against
`device_idle_share` x `frame_ms`, the counters and the span totals (ms per
frame). `--tracing 0` leaves the tracer off: the untraced `frame_ms`, for
the tracing's cost. `--tiny --device cpu` runs the cell cut to CPU size
(`portbench/tiny.py`), without set-up's wait."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _cell(name: str, tiny: bool):
    from portbench import harness
    from portbench.tiny import tiny_cell

    return tiny_cell(name) if tiny else harness.load_cell(name)


def run_cell(name: str, seed: int, seconds: float, tracing: bool, *,
             tiny: bool = False, device: str = "cuda") -> dict:
    import torch

    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
    from icra20_hand_object_pose_tpu_torch.utils import profiling
    from portbench import generator, harness, loops
    from portbench.spans import Spans

    spec, config, mix = _cell(name, tiny)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    traffic = generator.make(config, mix, seed, dev)
    n_obj = len(traffic.kinds)
    was_on = profiling.tracing(tracing)
    try:
        spans = Spans(on=True, events=on_card)
        loop = loops.load(traffic.loop).Loop(config, traffic, seed, dev, spans)

        def serve(i: int):
            spans.new_frame()
            return loop.serve(i)

        for i in range(traffic.setup_frames):
            serve(i)
        first = traffic.setup_frames
        if on_card:
            first, _ = harness.settle(serve, first, spans, name)
            torch.cuda.synchronize()
        spans.reset()
        profiling.reset()
        before = knn_cuda.launch_counts()
        w = harness.window(serve, first, seconds, n_obj)
        snap = profiling.snapshot(t_end=profiling.TRACER.t_reset + w["seconds"])
        after = knn_cuda.launch_counts()
    finally:
        profiling.tracing(was_on)
    frames = len(w["served"])
    frame_ms = 1e3 * w["seconds"] / frames
    out = {"workload": name, "seed": seed, "tracing": tracing, "frames": frames,
           "frame_ms": frame_ms, "failed": w["failed"],
           "launches": {k: {"per_frame": (after[k][0] - before[k][0]) / frames,
                            "shapes": {str(sh): n for sh, n in
                                       (after[k][1] - before[k][1]).items()}}
                        for k in after if after[k][0] > before[k][0]}}
    if on_card:
        frame_program_ms = spans.device_ms()
        harness.record_settled(name, frame_program_ms)
        program_ms = sum(frame_program_ms) / frames
        idle_share = 100.0 * (1.0 - program_ms / frame_ms)
        out.update(program_ms=program_ms, device_idle_share=idle_share,
                   device=torch.cuda.get_device_name(dev))
    if not tracing:
        return out
    per = snap["per_frame"]
    stage_sum = sum(per.get(f"{s}_ms", 0.0) for s in profiling.STAGES)
    out.update(per_frame=per, stage_sum_ms=stage_sum, counters=snap["counters"],
               span_ms={k: {"total": 1e3 * v["total_s"] / frames,
                            "self": 1e3 * v["self_s"] / frames, "count": v["count"]}
                        for k, v in snap["spans"].items()})
    if on_card:
        out["stage_sum_over_program"] = stage_sum / out["program_ms"]
        idle = snap["idle_s"] or {}
        out["idle_ms_by_span"] = {k: 1e3 * v / frames for k, v in idle.items()}
        out["idle_ms_split"] = {k: 1e3 * v / frames
                                for k, v in (snap["idle_split_s"] or {}).items()}
        out["idle_ms_vs_share"] = (per.get("idle_ms", 0.0),
                                   out["device_idle_share"] * frame_ms / 100.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="track.t42_box_vga")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--tracing", type=int, choices=(0, 1), default=1)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.tracing), tiny=a.tiny,
                   device=a.device)
    out["seconds_run"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
