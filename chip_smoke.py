"""GPU smoke check of the PyTorch/CUDA port (icra20_hand_object_pose_tpu_torch).

    python3 chip_smoke.py                  # one CUDA device, from the repo root
    python3 chip_smoke.py --kernels-only   # build + kernel phases, then stop
    python3 chip_smoke.py --kernels-only --ungrouped   # without the library's
                                           # grouped shapes (scripts/kernel_ab.sh:
                                           # a checkout from before them)
    python3 chip_smoke.py --sweep          # build + every launch plan, timed
    python3 chip_smoke.py --library-only   # build + kernel phases + phases 10-12,
                                           # 14, 15
    python3 chip_smoke.py --bench-only     # build + kernel phases + phase 13, then
                                           # scripts/profile_phases_torch.py
    scripts/kernel_ab.sh A B OUT           # kernel phases of two checkouts

Phases, in order; any failure raises and the script exits non-zero:

  1. device: a CUDA device is required (no CPU fallback); prints the card's
     name and power limit as nvidia-smi reports them;
  2. build:  compiles every kernel source (csrc/*.cu: K1 and K2 in
     nn_gather.cu, K3 in nn_gn.cu, both on the search core nn_search.cuh),
     one nvcc per source started together, into one library; prints
     ptxas' register and spill report;
  3. kernels, each against its plain PyTorch version on the card, timed:
     - K1 at the tracked frame's shapes (in-scan, explorer, polish/support)
       and the init frame's (in-scan and prescreen support: 1024 x 512 x
       512, polish: 17 x 2048 x 1024), shared and per-particle queries,
       plus a ragged case; at the same places of a library sweep of 8
       objects (8x the particles, one query per object and one shared by
       all), and at the in-scan and explorer shapes of the benchmark's
       library of 8 x 128 particles (1024 and 64 x 512 x 256, a query per
       object), and at the mesh's per-shard shapes of phase 14
       (SHARD_SHAPES), and at the tracked step's shapes of phase 15's
       libraries of 2 and 32 objects (BLIND_SHAPES), and at phase 17's
       shapes (GATE_SHAPES); then the tie cases (every reference point duplicated across
       the ranges a block's thread groups split the cloud into), ungrouped
       and grouped: the same indices, d2 bitwise equal, matched points and
       normals bitwise equal (the plain version of a shape above 2^27
       pairs runs in 8 slices of the particle axis);
     - K2 at the same shapes: the same indices, d2 bitwise equal;
     - K3 at the tracked scan (512 x 512 x 256), the explorer pulls (32 x
       512 x 256), the init scan (1024 x 512 x 512) and a ragged case, the
       same three of a library sweep with a scene per object (8 scenes, the
       last nearly empty), the tracked scan and explorer pulls of the
       libraries of 2 and 32 objects, then tie cases and 4096-point scenes: H, g and
       wrr within rtol 1e-4 plus an atol of 1e-5 x the largest |H| entry of
       that particle (the two sum in other orders), wsum and hits within
       1e-5 relative, a repeated call bitwise equal, and each object's
       group launched alone bitwise equal to the grouped launch;
     timing columns per shape: device ms per launch (20-50 calls captured
     in one CUDA graph, timed with events: the card's time, host excluded),
     the kernels one call launches (torch.profiler, by name), ms per call
     incl. host issue (events around a loop of wrapper calls: the host's
     time wherever it is the slower side), host us per wrapper call, the
     plain version's ms, the bound, and the exact-form floor;
  4. main path, track (the repo's benchmark configuration: VGA at
     fx=fy=570, box object, T42 hand, 2048 scene / 1024 model / 2048 render
     points, 512 particles x 10 iterations), a splat-rendered frame with
     1 mm noise, a Tracker seeded at the ground truth, 5 calls of
     Tracker.step: no re-init, finite poses, ADD-S < 5 mm, K1 launched;
     then one more frame under torch.profiler (device busy vs idle share,
     and the operators that take the most device time);
  5. cold start: an unseeded Tracker under IcpConfig(fused_gn=True) on the
     same frame: frame 0 re-initialises (TrackerConfig's init program:
     1024 particles x 20 iterations, 4096-orientation prescreen, hand-base
     auto-arm), frames 1-4 track; K3 launched in frame 0 and in the tracked
     frames; frame 0 (or, as recovery credit, frame 1) within ADD-S 10% of
     the diameter, frames 2-4 under 5 mm; then a forced watchdog (fitness
     0) re-initialises, under torch.profiler;
  6. nn_fn: 3 tracked frames with Estimator(nn_fn=make_nn_fn()) seeded at
     the ground truth: K2 launched, K1 not, ADD-S < 5 mm;
  7. sequence: the command line's `demo` at full width, in-process, in a
     temporary directory (VGA, 512 particles, the default EstimatorConfig,
     box, T42 hand, SyntheticSequenceConfig's defaults: 2 degrees and 4 mm
     per frame, 1 mm noise, 2% dropout, joint offset 0.05 rad): 8 frames
     rastered on the card, saved in the recorded layout, read back, tracked
     from a cold start, then `eval` on what it wrote, with the pose files
     as `--ref-poses` of the jsonl dump. Both return 0; the promised files
     exist; the PNG round trip is within half a depth unit of the generated
     frames; the depths read through the native loader (use_native=True)
     bitwise the Python codec's, each decoder's ms/frame printed; the
     sequence copied into the released layout (renumbered from 7, poses
     under annotated_poses/, hand bases under hand_pose/), converted by
     scripts/convert_reference_dataset.py and read through the port
     (native and Python): depths, rgb, poses, hand bases and joints
     bitwise what was written; frame 0 re-initialised and no later frame did; frame 0 or
     frame 1 within ADD-S 10% of the diameter, frames 2-7 under 5 mm; the
     parity report of the dump against itself reads identical; K1 launched
     and K2, K3 not;
  8. checkpoint: frames 0-3 of that sequence, Tracker.save, a second
     Tracker that loads it, frames 4-7 with both: poses bitwise equal, and
     the whole run bitwise equal to the poses phase 7 wrote; then a forced
     watchdog re-initialises with the default configuration,
     under torch.profiler;
  9. pixel mode: 3 frames of the sequence tracked from the ground truth
     under ScoreConfig(mode="pixel"): no re-init, ADD-S < 5 mm; then one
     more frame under torch.profiler;
  10. library, per scene (BASELINE config 5 at its `--sweep-scale` size: 8
     objects, box / cylinder / sphere / ellipsoid twice, ObjectModel(mesh,
     seed=i), config 3's camera and sizes, one splat-rendered frame per
     object): LibrarySweep from init_state(): step 0 re-initialises every
     object, steps 1-3 track (no healthy object re-initialises); every
     object within ADD-S 10% of its diameter on step 0 or 1 and under 5 mm
     on steps 2-3; K1 alone carries it, every launch with one scene per
     object (never a launch per object); then one tracked step under
     torch.profiler, printed beside phase 4's single frame (ms, ATen
     operator calls, device time), failing unless the step issues under 4x
     the single frame's operator calls; then the per-frame `_scene_prep`
     loop alone under torch.profiler (its share of the step);
  11. library, shared scene: 8 models of the box on one frame,
     shared_scene=True: an init step and 2 tracked steps, all under 5 mm on
     the tracked steps; object 0's init result bitwise equal to the
     per-scene path fed 8 copies of the frame with the same seeds;
  12. library through K2 and K3: one tracked sweep step from the ground
     truth with nn_fn=make_nn_fn() (K2 launched, K1 not) and one under
     IcpConfig(fused_gn=True) (K3 launched), each grouped and under 5 mm;
     save_state, load_state into a second sweep, the next step bitwise
     equal; `cli sweep` in-process on two recorded sequences (box and
     cylinder, 3 frames, VGA, the default configuration), its files read
     back;
  13. bench: `benchmarks.main()` (BASELINE config 3: the frame program's
     ms/frame and hypotheses/s, `Tracker.step` ms/frame, one profiled frame)
     and `benchmarks.bench_sweep()` (8 objects x 128 particles) in-process:
     each prints exactly one JSON line with its keys, every number in it
     finite and > 0; printed beside phase 4's frame; every launch at a
     checked shape;
  14. the mesh (parallel.make_mesh; one process per rank):
     (a) a process group of one over NCCL: 3 frames of
     Tracker(Estimator(mesh=make_mesh(1))) at config 3 from the ground
     truth (ADD-S < 5 mm, K1 launched), then LibrarySweep(mesh=
     make_mesh(1, "obj")) on phase 10's inputs: its init step and its track
     step bitwise phase 10's;
     (b) two spawned ranks on the one card over gloo (the kernels built
     here before they start): 2 frames of the swarm split 256 + 256
     (Estimator(mesh=make_mesh(2, "p"))): pose, fitness and hypothesis
     slots bitwise equal on both ranks, ADD-S < 5 mm; the object-sharded
     sweep (4 objects a rank): init and track step bitwise phase 10's; a
     tracked step of the (1, 2) mesh with each swarm over "p": finite,
     ADD-S < 5 mm per object. Each rank returns its launch counts and
     shapes, checked as every path phase's;
     (c) with two cards or more, (b) over NCCL, one rank per card;
     otherwise a line says why it did not run;
     each printed beside phase 4's frame and phase 10's step (ms). Two
     ranks on one card are no speed-up and are not read as one;
  15. blind paths, the sweep paths no other phase runs (phase 10's
     library and sizes unless said): (1) a sweep init through K2
     (nn_fn) and one under fused_gn (K3), each init step then one tracked
     step: every object within ADD-S 10% of its diameter on step 0 or 1,
     K2 without K1 and at the init scan (8192, 8, 512, 512), K3 there too,
     each grouped; (2) a mixed step from phase 10's tracked state with the
     fitness of objects 1 and 5 forced to 0: exactly those re-initialize,
     each object bitwise the all-init or all-track program's from the same
     state and seeds, the next state's bookkeeping (vel_ok, pose_tracked,
     prev_poses, key) as LibrarySweep._finish writes it; (3) at O = 8, 2
     (objects 0-1) and 32 (the 4 meshes cycled, ObjectModel(mesh, seed=i)),
     one tracked step's program from the ground truth in the default
     configuration, through nn_fn and under fused_gn: object 0 and the last
     bitwise their single estimates (Estimator of that object, its seed),
     every result field, ADD-S < 5 mm; (4) O = 2 in pixel mode, 2 tracked
     steps: no re-init, ADD-S < 5 mm, object 0 bitwise its single
     estimate, peak device memory printed; (5) each of the 8 objects its
     own moving sequence (generate_sequence on the card, seed o, 4 frames):
     4 steps from init_state() (step 0 re-initialises all, no later step
     does; within 10% of the diameter on step 0 or 1, steps 2-3 < 5 mm),
     then from the state after step 1 two tracked steps under
     TrackerConfig(motion_prior=1.0) and two under n_hypotheses=2, finite,
     < 5 mm, each printing the prior branch of LibrarySweep._prep it took
     (checked against the prior built); every case's launches checked by
     shape; runs under --library-only too;
  16. scripts, in-process on the card: calibrate_base_agree_torch.py
     --trials 2 and ab_scan_icp_torch.py --frames 2 --seeds 1 --only base:
     each the reference's JSON keys, every number finite, under 60 s;
  17. accuracy gates: every case of the reference's six statistical test
     files (tests/torch_gate_cases.py: the occlusion levels, the pinned
     accuracy cases, the realistic tracking, init and excursion cases, the
     sensor model, both base-refine regimes, the global inits, the slide
     cases, the concave mug) on the card at seeds 0 .. S_card - 1 (at
     least GATE_MIN_SEEDS, more while 1.5x a seed still fits the
     phase's budget), each
     printed as passes / S_card with the median and worst of its first
     asserted statistic beside the reference's passes / S and the same
     statistics (tests/torch_gate_reference.json, the JAX package on the
     CPU over S = 8 seeds). The gate: (1) pooled over every case, the
     port's pass count must not fall below the reference's pooled pass
     rate by a one-sided Fisher exact test at p < 0.01
     (scipy.stats.fisher_exact, alternative "less"); (2) no case that the
     reference passed on all S of its seeds may fail on a majority of the
     card's seeds. Nothing else is a pass/fail threshold. (b) phase 7's
     sequence tracked again (a cold start, the demo's estimator) and held
     against the JAX package's two streams of the same sequence (keys 0
     and 1, tests/torch_ref_pose_stream.json): with d(a, b) the mean over
     frames of the ADD-S between two streams on the dense cloud,
     d(port, ref0) <= k d(ref1, ref0) + m, k and m as the reference
     measured them (pose_stream in torch_gate_reference.json); BASELINE's
     reading (mean ADD-S against the ground truth within 1 mm of the
     reference's) is printed, not gated. Every launch at a checked shape
     (GATE_SHAPES), launches by kernel and shape printed, the phase's
     seconds printed against its budget; a {"gates": ...} JSON line holds
     the per-case table;
  18. prints the kernels' JSON line, then {"ok": true, "device": ...} last.

Every phase prints its seconds.

Each path phase sets every launch count to 0 just before it and reads the
counts just after; the JSON line's `launches` are those of the path that
carries the kernel (K1: phase 4, K3: phase 5, K2: phase 6), and its
`library_sweep_launches` those of the library paths (K1: phase 10, K2 and
K3: their step of phase 12), its `mesh_launches` each kernel's launches
in phase 14, summed over (a) and every rank of (b) and (c) (K1 carries
it; K2 and K3 read 0 unless a mesh path launched them), its
`blind_path_launches` each kernel's launches over phase 15, its
`gate_launches` those over phase 17; `shapes` holds every timed shape's
numbers.
Phases 7-9 and 11 run K1 too and print their own counts. Each path phase
also reads the (P, blocks, Ns, Nm) of every launch it made and fails if
phase 3 did not hold that kernel against its plain version at that shape.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPLACES = {
    "K1": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:220",
    "K2": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:78",
    "K3": "icra20_hand_object_pose_tpu/ops/knn_pallas.py:412",
}
SOURCE = {
    "K1": "icra20_hand_object_pose_tpu_torch/csrc/nn_gather.cu",
    "K2": "icra20_hand_object_pose_tpu_torch/csrc/nn_gather.cu",
    "K3": "icra20_hand_object_pose_tpu_torch/csrc/nn_gn.cu",
}
# (P, Ns, Nm) that a frame hands K1 (and K2 through nn_fn). Tracked:
# in-scan ICP and support on the 512 x 256 subsets, the 32 explorer seeds on
# the same subsets, the polish and fine-tier support on the full clouds
# (1 + 8 top + 1 explorer + 8 slides = 18 candidates). Init: the in-scan ICP
# of 1024 particles and the prescreen's support re-rank of its best 1024
# candidates, both on 512 scene x 512 model points, and the polish without
# an explorer candidate (17). And one ragged case
NN_SHAPES = [(512, 512, 256), (32, 512, 256), (18, 2048, 1024),
             (1024, 512, 512), (17, 2048, 1024), (3, 37, 73)]
# the same places of a library sweep of LIB objects, the object axis folded
# into the particle axis: (P = LIB x particles, Ns, Nm), run with one query
# (scene) per object (Pq = LIB) and with one shared by all (Pq = 1, the
# shared-scene mode); and a ragged case (P, Pq, Ns, Nm)
LIB = 8
# the library's meshes, cycled over its objects (BASELINE config 5)
LIB_MESHES = ["box", "cylinder", "sphere", "ellipsoid"]
LIB_SHAPES = [(LIB * P, Ns, Nm) for P, Ns, Nm in NN_SHAPES[:5]]
# and the in-scan ICP and the explorer (8 seeds an object) of the benchmark's
# library of LIB x 128 particles (`benchmarks.bench_sweep`'s default)
BENCH_SWEEP_SHAPES = [(LIB * 128, LIB, 512, 256), (LIB * 8, LIB, 512, 256)]
# phase 15's libraries of 2 and 32 objects, tracked: the in-scan ICP, the
# explorer and the polish with a query per object (K3: in-scan and explorer,
# a scene per object)
BLIND_SIZES = (2, 32)
BLIND_SHAPES = [(O * P, O, Ns, Nm) for O in BLIND_SIZES for P, Ns, Nm in NN_SHAPES[:3]]
NN_GROUPED = ([(P, Pq, Ns, Nm) for P, Ns, Nm in LIB_SHAPES for Pq in (1, LIB)]
              + BENCH_SWEEP_SHAPES + BLIND_SHAPES + [(12, 3, 37, 73)])
# the per-shard shapes of phase 14 (P, B, Ns, Nm): a tracked frame whose swarm
# is split over 2 ranks (in-scan and explorer at 256 particles a rank; the
# polish keeps 18 candidates); the sweep of LIB objects over 2 ranks (tracked
# in-scan, explorer and polish, init in-scan and prescreen support, and the
# init polish of 4 objects); the (1, 2) mesh (LIB objects x 256 a rank,
# tracked in-scan and explorer)
HALF = LIB // 2
SHARD_SHAPES = [(256, 1, 512, 256), (16, 1, 512, 256),
                (HALF * 512, HALF, 512, 256), (HALF * 32, HALF, 512, 256),
                (HALF * 18, HALF, 2048, 1024), (HALF * 1024, HALF, 512, 512),
                (HALF * 17, HALF, 2048, 1024),
                (LIB * 256, LIB, 512, 256), (LIB * 16, LIB, 512, 256)]
# phase 17's launches (P, B, Ns, Nm), K1 alone: the reference gates' 320 x
# 240 configuration (1024 scene points, 256 particles, 512 at init) tracked
# (in-scan, explorer, polish) and at init (in-scan and prescreen support,
# polish), and the concave mug's 160 x 120 one (768 scene / 256 model
# points, 32 particles, 64 at init)
GATE_SHAPES = [(256, 1, 512, 256), (16, 1, 512, 256), (18, 1, 1024, 1024),
               (512, 1, 512, 512), (17, 1, 1024, 1024),
               (2, 1, 512, 256), (18, 1, 768, 256), (64, 1, 512, 256),
               (17, 1, 768, 256)]
# phase 17: the least number of seeds per case, the most, and the phase's
# budget in seconds: one more seed runs only while 1.5x the slowest seed so
# far still fits (seeds took 44-50 s on one H100 host; a slower host must
# not run past the budget)
GATE_MIN_SEEDS, GATE_MAX_SEEDS, GATE_BUDGET_S, GATE_SEED_MARGIN = 3, 8, 200.0, 1.5
# the one-sided Fisher test's level of the pooled gate
GATE_P = 0.01
# tie cases, checked only (P, Pq, Ns, Nm): the polish shape and the ragged
# one with every reference point duplicated across the split ranges (see
# `_ties`), with a shared query and with one per group
TIE_SHAPES = [(18, 1, 2048, 1024), (3, 1, 37, 73), (LIB * 18, LIB, 2048, 1024),
              (12, 3, 37, 73)]
# (P, Ns, Nm) of K3: the tracked scan, the explorer pulls, the init scan,
# one ragged case
GN_SHAPES = [(512, 512, 256), (32, 512, 256), (1024, 512, 512), (3, 90, 130)]
# K3 with a scene per object (P, G, Ns, Nm): the sweep's tracked scan,
# explorer pulls and init scan, the tracked scan and explorer pulls of
# phase 15's libraries of 2 and 32 objects, and a ragged case
GN_GROUPED = ([(LIB * 512, LIB, 512, 256), (LIB * 32, LIB, 512, 256),
               (LIB * 1024, LIB, 512, 512)]
              + [(O * P, O, Ns, Nm) for O in BLIND_SIZES for P, Ns, Nm in GN_SHAPES[:2]]
              + [(12, 3, 90, 130)])
# K3 checks beyond the main path (P, G, Ns, Nm, ties): the explorer pulls
# with ties across its model ranges, alone and grouped, and a scene larger
# than one launch covers at once (each block walks 4 chunks)
GN_CHECKS = [(32, 1, 512, 256, True), (3, 1, 4096, 256, False),
             (LIB * 32, LIB, 512, 256, True), (6, 2, 4096, 256, True)]
# the plain versions hold a dense [P, Ns, Nm] distance tensor: above this
# many pairs they run in slices of the particle axis
PLAIN_PAIRS = 2 ** 27
# published H100 SXM peaks: FP32 outside the tensor cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# `cli demo` of the sequence phase: VGA, 512 particles, everything else the
# command's and EstimatorConfig's defaults
DEMO = dict(frames=8, width=640, height=480, particles=512)
# the bench phase's JSON lines: the keys each must hold
BENCH_KEYS = {
    "main": {"metric", "value", "unit", "vs_baseline", "ms_per_frame",
             "e2e_tracker_ms_per_frame", "full_refine_equiv_per_sec",
             "device_ms_per_frame", "idle_share", "aten_calls_per_frame",
             "device", "power_limit_w"},
    "bench_sweep": {"metric", "value", "unit", "vs_baseline", "hyp_per_sec_chip",
                    "ms_per_object_frame", "device", "power_limit_w"},
}
# the keys of the two scripts' JSON (phase 16): per regime of
# calibrate_base_agree_torch.py, and per variant of ab_scan_icp_torch.py
CALIBRATE_KEYS = {"score_min", "score_max", "gain_min", "gain_median", "gain_max",
                  "gains"}
AB_SCAN_KEYS = {"variant", "shape", "ms_per_frame", "tracked_add_mm", "add_mm_median",
                "add_mm_p90", "n_over_5mm", "n_err"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def time_ms(fn, reps: int) -> float:
    """CUDA events around `reps` calls of `fn`, per call: the device's time
    when it is the slower side, the host's time to issue a call when the
    host is."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_names(fn, reps: int = 10) -> list[str]:
    """The CUDA kernels that `reps` calls of `fn` launched, by name, from
    torch.profiler (names only: it may drop events of short kernels, and
    now and then records none, even three times running, so an empty
    profile is taken again, up to six times)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(6):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA
                        and not getattr(e, "is_user_annotation", False)})
        if names:
            return names
    raise RuntimeError("the profiler recorded no kernel on the card")


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device ms per call: `reps` calls captured in one CUDA graph, each of
    `replays` replays timed with events, the median replay over `reps`. The
    host takes no part in a replay, so this is the card's time for the
    call's kernels and the gaps between them."""
    import statistics

    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def host_us(fn, reps: int) -> float:
    """Host time per call to issue `fn` (no synchronisation inside)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * elapsed / reps


def timings(run, plain, reps: int) -> dict:
    """Device ms per launch (CUDA graph), the kernels a call launches, ms per
    call incl. host issue (events around a loop of calls), host us per call,
    and the plain version's ms per call (events)."""
    return dict(ms=graph_ms(run, reps), kernels_per_call=len(kernel_names(run)),
                call_ms=time_ms(run, reps), host_us=host_us(run, reps),
                plain_ms=time_ms(plain, max(3, reps // 5)))


def floor_ms(pairs: float) -> float:
    """Exact-form floor of the search: 11 issued instructions per (query,
    ref) pair (3 sub, 3 mul, 2 add, a compare and 2 selects, no FMA) at
    132 SMs x 128 lanes x 1.98 GHz = 33.5 T lane-instructions/s."""
    return 1e3 * 11.0 * pairs / 33.5e12


def report(tag: str, where: str, t: dict, b_ms: float, b_by: str, pairs: float) -> None:
    print(f"{tag} {where}: device {t['ms']:.5f} ms/launch "
          f"({t['kernels_per_call']} kernel(s)/call), call incl. host issue "
          f"{t['call_ms']:.5f} ms, host {t['host_us']:.1f} us/call, plain "
          f"{t['plain_ms']:.4f} ms, bound {b_ms:.5f} ms ({b_by}), exact-form "
          f"floor {floor_ms(pairs):.5f} ms", flush=True)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """Least time on the card (ms) for `ops` FP32 operations and `nbytes`
    moved once, and which of the two sets it."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def nn_bound(P, Pq, Ns, Nm, gather: bool) -> tuple[float, str]:
    """K1/K2: 9 operations per (query, ref) pair (3 sub, 3 mul, 2 add, 1
    compare); query and ref points (and K1's normals) read once, d2 and idx
    (and K1's matched point and normal) written once."""
    n_in = 3 * Pq * Ns + (6 if gather else 3) * P * Nm
    n_out = (8 if gather else 2) * P * Ns
    return bound(9.0 * P * Ns * Nm, 4.0 * (n_in + n_out))


def gn_bound(P, G, Ns, Nm) -> tuple[float, str]:
    """K3: the search's 9 operations per pair plus ~105 per (particle,
    scene point) for gates, J, r, the 30 products and their sums; G scenes
    (7 floats a point) and posed model (6) read once, H, g, wsum, hits, wrr
    (45 floats a particle) written once."""
    ops = 9.0 * P * Ns * Nm + 105.0 * P * Ns
    return bound(ops, 4.0 * (7 * G * Ns + 6 * P * Nm + 45 * P))


def in_slices(plain, blocks, refs, n: int):
    """plain(*blocks, *refs) in `n` slices of the particle axis of `refs`
    ([P, ...]) and the matching slices of `blocks` ([B, ...], B = 1 or a
    multiple of n that divides P), concatenated."""
    import torch

    if n == 1:
        return plain(*blocks, *refs)
    step = refs[0].shape[0] // n
    outs = []
    for c in range(n):
        B = blocks[0].shape[0]
        bs = slice(0, 1) if B == 1 else slice(c * B // n, (c + 1) * B // n)
        outs.append(plain(*(b[bs] for b in blocks),
                          *(r[c * step:(c + 1) * step] for r in refs)))
    return tuple(torch.cat(o) for o in zip(*outs))


def plain_slices(P, B, Ns, Nm) -> int:
    """Slices for `in_slices`: LIB above PLAIN_PAIRS pairs, where the block
    count allows it."""
    big = P * Ns * Nm > PLAIN_PAIRS and P % LIB == 0 and (B == 1 or B % LIB == 0)
    return LIB if big else 1


def _plan_kw(plan) -> dict:
    """The wrappers' `plan` argument, left out when None: the kernel phases
    also time checkouts whose wrappers take no plan (scripts/kernel_ab.sh)."""
    return {} if plan is None else {"plan": plan}


def _plan_of(knn_cuda, name: str, *shape) -> str:
    fn = getattr(knn_cuda, name, None)
    return str(fn(*shape)) if fn else "(no plan)"


def _cloud(gen, shape, dev, scale=0.3, centre=0.5):
    import torch

    c = torch.tensor([0.0, 0.0, centre], device=dev)
    return (torch.rand(shape, generator=gen, device=dev) - 0.5) * scale + c


def _ties(r) -> None:
    """Copies the first half of each reference cloud into the second half
    (and, for odd Nm, point Nm//2 - 1 into the last slot), in place: every
    query's minimum is then reached at j and at j + Nm//2 at least, across
    the ranges that a block's thread groups split the cloud into, and the
    lower index must win."""
    h = r.shape[1] // 2
    r[:, h:2 * h] = r[:, :h]
    if r.shape[1] % 2:
        r[:, -1] = r[:, h - 1]


def nn_case(knn_cuda, gen, dev, gather: bool, P, Pq, Ns, Nm, ties=False, plan=None):
    """One K1 (gather) or K2 case against its plain version: indices equal
    everywhere and d2 bitwise equal (K1: the matched points and normals
    too). Returns (run, plain, max |d2 err|)."""
    import torch

    tag = "K1" if gather else "K2"
    q = _cloud(gen, (Pq, Ns, 3), dev)
    q[:, ::17] = 1e6                      # scene padding rows
    r = _cloud(gen, (P, Nm, 3), dev)
    if ties:
        _ties(r)
    where = f"P={P} Pq={Pq} Ns={Ns} Nm={Nm}{' ties' if ties else ''} {plan or ''}"
    n_sl = plain_slices(P, Pq, Ns, Nm)
    if gather:
        n = torch.nn.functional.normalize(
            torch.randn((P, Nm, 3), generator=gen, device=dev), dim=-1)
        run = lambda: knn_cuda.nn_gather_batched(q, r, n, **_plan_kw(plan))
        plain = lambda: in_slices(knn_cuda.nn_gather_plain, (q,), (r, n), n_sl)
        m, nm, d2, idx = run()
        mp, nmp, d2p, idxp = plain()
    else:
        run = lambda: knn_cuda.nn_batched(q, r, **_plan_kw(plan))
        plain = lambda: in_slices(knn_cuda.nn_plain, (q,), (r,), n_sl)
        idx, d2 = run()
        idxp, d2p = plain()
    torch.cuda.synchronize()
    agree = (idx == idxp).float().mean().item()
    err = (d2 - d2p).abs().max().item()
    check(agree == 1.0, f"{tag} index agreement {agree} at {where}")
    check(bool(torch.equal(d2, d2p)), f"{tag} d2 not bitwise equal at {where}")
    if gather:
        check(bool(torch.equal(m, mp) and torch.equal(nm, nmp)),
              f"K1 matched point/normal differ at {where}")
    print(f"{tag} {where}: idx agree {agree:.6f}, max|d2 err| {err:.3e}", flush=True)
    return run, plain, err


def nn_phase(knn_cuda, dev, gather: bool, grouped: bool = True) -> dict:
    """K1 (gather) or K2 against its plain version at every main-path shape,
    shared and per-particle queries, at the library sweep's shapes, one
    query per object and one for all, and at the mesh's per-shard shapes,
    timed; then the tie cases, checked only. Returns the in-scan numbers,
    with every shape's under "shapes"."""
    import torch

    tag = "K1" if gather else "K2"
    gen = torch.Generator(device=dev).manual_seed(0 if gather else 1)
    max_err, res = 0.0, {}
    cases = [(P, Pq, Ns, Nm) for P, Ns, Nm in NN_SHAPES for Pq in (1, P)]
    # (a shape on two lists runs once)
    for P, Pq, Ns, Nm in dict.fromkeys(cases + (NN_GROUPED + SHARD_SHAPES + GATE_SHAPES
                                                if grouped else [])):
        run, plain, err = nn_case(knn_cuda, gen, dev, gather, P, Pq, Ns, Nm)
        max_err = max(max_err, err)
        t = timings(run, plain, 50 if P * Ns * Nm < 1e8 else 20)
        b_ms, b_by = nn_bound(P, Pq, Ns, Nm, gather)
        report(tag, f"P={P} Pq={Pq} Ns={Ns} Nm={Nm} {_plan_of(knn_cuda, 'nn_plan', P, Ns, Nm)}",
               t, b_ms, b_by, P * Ns * Nm)
        res[(P, Pq, Ns, Nm)] = dict(t, bound_ms=b_ms, bound_by=b_by)
    for P, Pq, Ns, Nm in TIE_SHAPES if grouped else TIE_SHAPES[:2]:
        max_err = max(max_err, nn_case(knn_cuda, gen, dev, gather, P, Pq, Ns, Nm,
                                       ties=True)[2])
    return dict(max_abs_err=max_err, **res[(512, 1, 512, 256)],
                shapes={f"P={P} Pq={Pq} Ns={Ns} Nm={Nm}": v
                        for (P, Pq, Ns, Nm), v in res.items()})


def gn_case(knn_cuda, gen, dev, P, G, Ns, Nm, ties=False, plan=None):
    """One K3 case against its plain version: H, g and wrr within rtol 1e-4
    plus 1e-5 x the particle's largest |H| entry, wsum and hits within 1e-5
    relative, finite, and a repeated call bitwise equal. With G > 1 scenes
    the last one is left nearly empty (5 points of weight: its particles,
    and only they, must read wsum <= 5), and each group launched alone (by
    default with its own default plan) must give the grouped launch's bits.
    Returns (run, plain, max |err| over H, g, wrr)."""
    import math

    import torch

    gates = dict(maxd2=0.02 ** 2, min_cos=math.cos(math.radians(60.0)),
                 tau2=0.01 ** 2)
    # anchored clouds of object size; scene padding rows far out, weight 0
    scene = _cloud(gen, (G, Ns, 3), dev, scale=0.1, centre=0.0)
    snrm = torch.nn.functional.normalize(
        torch.randn((G, Ns, 3), generator=gen, device=dev), dim=-1)
    snrm[:, ::11] = 0.0                                # missing normals
    sw = (torch.rand((G, Ns), generator=gen, device=dev) > 0.1).float()
    scene[:, ::13] = 1e6
    sw[:, ::13] = 0.0
    if G > 1:
        sw[-1, 6:] = 0.0                               # a nearly empty object
    else:
        scene, snrm, sw = scene[0], snrm[0], sw[0]     # the [Ns, ...] form
    ref = _cloud(gen, (P, Nm, 3), dev, scale=0.1, centre=0.0)
    if ties:
        _ties(ref)
    rnrm = torch.nn.functional.normalize(
        torch.randn((P, Nm, 3), generator=gen, device=dev), dim=-1)
    where = f"P={P} G={G} Ns={Ns} Nm={Nm}{' ties' if ties else ''} {plan or ''}"
    run = lambda: knn_cuda.nn_gn_batched(scene, snrm, sw, ref, rnrm, **gates,
                                         **_plan_kw(plan))
    plain_fn = lambda *a: knn_cuda.nn_gn_plain(*a, **gates)
    if G > 1:
        plain = lambda: in_slices(plain_fn, (scene, snrm, sw), (ref, rnrm),
                                  plain_slices(P, G, Ns, Nm))
    else:
        plain = lambda: plain_fn(scene, snrm, sw, ref, rnrm)
    out, ref_out, again = run(), plain(), run()
    torch.cuda.synchronize()
    H, g, wsum, hits, wrr = out
    Hp, gp, wsump, hitsp, wrrp = ref_out
    check(all(bool(torch.isfinite(t).all()) for t in out),
          f"K3 non-finite output at {where}")
    check(all(torch.equal(a, b) for a, b in zip(out, again)),
          f"K3 repeated call not bitwise equal at {where}")
    scale = Hp.abs().amax(dim=(1, 2))                  # [P]
    errs = []
    for name, a, b in (("H", H, Hp), ("g", g, gp), ("wrr", wrr, wrrp)):
        sc = scale.reshape((P,) + (1,) * (a.dim() - 1))
        ok = (a - b).abs() <= 1e-4 * b.abs() + 1e-5 * sc
        check(bool(ok.all()), f"K3 {name} disagrees at {where}: "
              f"max err {(a - b).abs().max().item():.3e}")
        errs.append((a - b).abs().max().item())
    for name, a, b in (("wsum", wsum, wsump), ("hits", hits, hitsp)):
        check(bool(((a - b).abs() <= 1e-5 * b.abs()).all()),
              f"K3 {name} disagrees at {where}")
    if G > 1:
        per = P // G
        check(bool((wsum[-per:] <= 5.0).all()) and bool((wsum[:per] > 6.0).all()),
              f"K3 groups leak at {where}: wsum of the empty object "
              f"{wsum[-per:].max().item()}, of object 0 {wsum[:per].min().item()}")
        for o in range(G):
            sl = slice(o * per, (o + 1) * per)
            alone = knn_cuda.nn_gn_batched(scene[o], snrm[o], sw[o], ref[sl], rnrm[sl],
                                           **gates, **_plan_kw(plan))
            check(all(torch.equal(a[sl], b) for a, b in zip(out, alone)),
                  f"K3 group {o} alone differs from the grouped launch at {where}")
    print(f"K3 {where}: max|err| H {errs[0]:.3e} g {errs[1]:.3e} "
          f"wrr {errs[2]:.3e}, mean inlier mass {wsum.mean().item():.2f}, "
          f"repeat bitwise equal"
          f"{', each group alone bitwise equal' if G > 1 else ''}", flush=True)
    return run, plain, max(errs)


def k3_phase(knn_cuda, dev, grouped: bool = True) -> dict:
    """K3 vs plain at the tracked scan, explorer, init scan and a ragged
    shape, and at the library sweep's with a scene per object, timed; then
    tie cases and scenes larger than one launch covers at once, checked
    only. Returns the tracked-scan numbers, every shape's under "shapes"."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(2)
    max_err, res = 0.0, {}
    for P, G, Ns, Nm in ([(P, 1, Ns, Nm) for P, Ns, Nm in GN_SHAPES]
                         + (GN_GROUPED if grouped else [])):
        run, plain, err = gn_case(knn_cuda, gen, dev, P, G, Ns, Nm)
        max_err = max(max_err, err)
        t = timings(run, plain, 50 if P * Ns * Nm < 1e8 else 20)
        b_ms, b_by = gn_bound(P, G, Ns, Nm)
        report("K3", f"P={P} G={G} Ns={Ns} Nm={Nm} "
               f"{_plan_of(knn_cuda, 'gn_plan', P // G, Ns, Nm)}",
               t, b_ms, b_by, P * Ns * Nm)
        res[(P, G, Ns, Nm)] = dict(t, bound_ms=b_ms, bound_by=b_by)
    for P, G, Ns, Nm, ties in GN_CHECKS if grouped else GN_CHECKS[:2]:
        max_err = max(max_err, gn_case(knn_cuda, gen, dev, P, G, Ns, Nm, ties)[2])
    return dict(max_abs_err=max_err, **res[(512, 1, 512, 256)],
                shapes={f"P={P} G={G} Ns={Ns} Nm={Nm}": v
                        for (P, G, Ns, Nm), v in res.items()})


def sweep_phase(knn_cuda, dev) -> None:
    """Device ms per launch (a CUDA graph of 20 calls) of the launch plans
    within the kernels' limits, at each main-path shape
    (shared queries), each checked against the plain version first; the
    plan that `nn_plan` / `gn_plan` picks is starred."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(3)
    P_, W = knn_cuda.Plan, knn_cuda.WIDTH

    def timed(tag, run, plan, chosen):
        print(f"sweep {tag} {tuple(plan)}: {graph_ms(run, 20):.5f} ms"
              f"{' *' if plan == chosen else ''}", flush=True)

    for gather in (True, False):
        for P, Ns, Nm in NN_SHAPES[:4]:
            chosen = knn_cuda.nn_plan(P, Ns, Nm)
            for q in (1, 2, 4):
                for groups in (1, 2, 4):
                    for width in (64, W):
                        plan = P_(q, groups, 1, width)
                        run, _, _ = nn_case(knn_cuda, gen, dev, gather, P, 1, Ns, Nm,
                                            ties=True, plan=plan)
                        timed(f"{'K1' if gather else 'K2'} P={P} Ns={Ns} Nm={Nm}", run,
                              plan, chosen)
    for P, Ns, Nm in GN_SHAPES[:3]:
        chosen = knn_cuda.gn_plan(P, Ns, Nm)
        for q in (1, 2, 4):
            for groups in (1, 2, 4):
                for ss in (1, 2, 4, 8):
                    if ss * q * W > Ns:
                        continue
                    plan = P_(q, groups, ss)
                    run, _, _ = gn_case(knn_cuda, gen, dev, P, 1, Ns, Nm, ties=True,
                                        plan=plan)
                    timed(f"K3 P={P} Ns={Ns} Nm={Nm}", run, plan, chosen)


class Scene:
    """BASELINE config 3's frame and models on the card."""

    def __init__(self, dev):
        import numpy as np

        from icra20_hand_object_pose_tpu_torch.datasets import (
            default_object_pose, hand_base_for_grasp, render_frame_fast,
        )
        from icra20_hand_object_pose_tpu_torch.models import (
            ObjectModel, make_t42_hand,
        )
        from icra20_hand_object_pose_tpu_torch.utils import meshio
        from icra20_hand_object_pose_tpu_torch.utils.config import (
            CameraIntrinsics, EstimatorConfig, PsoConfig,
        )

        self.cam = CameraIntrinsics(width=640, height=480, fx=570.0, fy=570.0,
                                    cx=320.0, cy=240.0)
        self.cfg = EstimatorConfig(camera=self.cam, scene_points=2048,
                                   pso=PsoConfig(particles=512, iters=10))
        self.mesh = meshio.make_test_object("box")
        self.hand = make_t42_hand(device=dev)
        self.obj = ObjectModel(self.mesh, model_points=1024, render_points=2048,
                               device=dev)
        self.pose_gt = default_object_pose()
        self.hand_base = hand_base_for_grasp(self.pose_gt)
        self.hand_q = np.asarray([0.45, 0.45], np.float32)
        self.depth = render_frame_fast(
            self.mesh, self.pose_gt, self.hand, self.hand_base, self.hand_q,
            self.cam, noise_sigma=0.001, rng=np.random.default_rng(0),
            device="cpu")   # the host splat: the same frame in every run
        self.dense, _ = self.mesh.sample_surface(8192, seed=123)

    def step(self, tracker, label: str, profiled: bool = False):
        """One Tracker.step on the static frame; see `timed_step`."""
        return timed_step(tracker, self, self.pose_gt, self.dense, label, profiled)


def timed_step(tracker, fr, pose_gt, dense, label: str, profiled: bool = False):
    """One Tracker.step on `fr` (.depth, .hand_base, .hand_q), timed to the
    pose on the host (under torch.profiler when `profiled`); returns
    (result, ms, ADD-S mm against pose_gt)."""
    import numpy as np

    from icra20_hand_object_pose_tpu_torch import evaluation

    def run():
        res = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
        return res, res.pose.cpu().numpy()

    (res, pose), ms, prof = timed_call(run, tracker.est.device, profiled)
    if profiled:
        timed_step.last_profile = prof
    check(pose.shape == (4, 4) and bool(np.isfinite(pose).all()),
          f"{label}: pose not finite")
    adds = 1000.0 * evaluation.add_s_error(pose, pose_gt, dense)
    print(f"{label}: {ms:.2f} ms, ADD-S {adds:.3f} mm, reinitialized "
          f"{res.reinitialized}, fitness {float(res.fitness):.4f}, "
          f"coverage {float(res.coverage):.4f}", flush=True)
    return res, ms, adds


def reset_counts(knn_cuda) -> None:
    for fn in (knn_cuda.nn_gather_batched, knn_cuda.nn_batched,
               knn_cuda.nn_gn_batched):
        fn.launches = 0
        fn.shapes.clear()


def counts(knn_cuda) -> dict:
    return {"K1": knn_cuda.nn_gather_batched.launches,
            "K2": knn_cuda.nn_batched.launches,
            "K3": knn_cuda.nn_gn_batched.launches}


def launched(knn_cuda) -> dict:
    """Each kernel's launches by (P, B, Ns, Nm) since the last reset."""
    return {"K1": dict(knn_cuda.nn_gather_batched.shapes),
            "K2": dict(knn_cuda.nn_batched.shapes),
            "K3": dict(knn_cuda.nn_gn_batched.shapes)}


def check_shapes(knn_cuda, path: str, seen: dict | None = None) -> None:
    """Every (P, B, Ns, Nm) launched since the last reset (or in `seen`, a
    `launched` result; B the query or scene blocks) must be one that the
    kernel phases held against the plain version (K1/K2: NN_SHAPES at B = 1
    and B = P, NN_GROUPED, SHARD_SHAPES and GATE_SHAPES; K3: GN_SHAPES at
    B = 1, and
    GN_GROUPED); prints the launches by shape."""
    seen = launched(knn_cuda) if seen is None else seen
    print(f"{path} launches by (P, blocks, Ns, Nm): "
          f"{ {k: v for k, v in seen.items() if v} }", flush=True)
    nn_ok = ({(P, B, Ns, Nm) for P, Ns, Nm in NN_SHAPES for B in (1, P)}
             | set(NN_GROUPED) | set(SHARD_SHAPES) | set(GATE_SHAPES))
    gn_ok = {(P, 1, Ns, Nm) for P, Ns, Nm in GN_SHAPES} | set(GN_GROUPED)
    for k, shapes in seen.items():
        unchecked = set(shapes) - (gn_ok if k == "K3" else nn_ok)
        check(not unchecked, f"{path} launched {k} at {sorted(unchecked)}, "
              f"where no kernel phase checks it against its plain version")


def track_phase(sc: Scene, knn_cuda) -> tuple[int, dict]:
    """Five tracked frames of the benchmark configuration from the ground
    truth, then one profiled frame; returns the K1 launches of the five and
    the single frame's numbers (ms/frame, and the profiled frame's wall and
    device ms and ATen calls) for the library phase to stand beside."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    tracker = Tracker(Estimator(sc.obj, sc.hand, sc.cfg), seed=0)
    tracker.state = tracker.state._replace(pose=sc.pose_gt, initialized=True,
                                           fitness=1.0)
    reset_counts(knn_cuda)
    frame_ms = []
    for i in range(5):
        res, ms, adds = sc.step(tracker, f"track frame {i}")
        frame_ms.append(ms)
        check(not res.reinitialized, f"frame {i} re-initialized")
        check(adds < 5.0, f"frame {i}: ADD-S {adds:.3f} mm >= 5 mm")
    n = counts(knn_cuda)
    check(n["K1"] > 0, "the tracked frames never launched K1")
    steady = sum(frame_ms[1:]) / len(frame_ms[1:])
    print(f"Tracker.step: {steady:.2f} ms/frame (frames 1-4; frame 0 "
          f"{frame_ms[0]:.2f} ms), launches in 5 frames {n}", flush=True)
    sc.step(tracker, "profiled track frame", profiled=True)
    check_shapes(knn_cuda, "track path")
    return n["K1"], dict(timed_step.last_profile, frame_ms=steady)


def timed_call(fn, dev, profiled: bool = False):
    """fn() timed on the host clock to the end of its device work, under
    torch.profiler when `profiled` (utils/profiling.profile_counts: device
    kernel time against the wall time gives the card's idle share, then the
    operators that take the most device time are printed). Returns (fn's
    result, wall ms, the profile's wall and device ms and ATen operator
    calls, or None)."""
    import torch

    from icra20_hand_object_pose_tpu_torch.utils.profiling import profile_counts

    if not profiled:
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize(dev)
        return out, 1000.0 * (time.perf_counter() - t0), None
    prof = profile_counts(fn, device=dev)
    wall_ms, busy_ms, n_ops = prof["wall_ms"], prof["device_ms"], prof["aten_calls"]
    print(f"profiled frame: {wall_ms:.2f} ms wall, {busy_ms:.3f} ms device "
          f"kernels ({100.0 * (1.0 - busy_ms / wall_ms):.1f}% idle), "
          f"{n_ops} aten operator calls", flush=True)
    print(prof["events"].table(sort_by="self_device_time_total", row_limit=15),
          flush=True)
    return prof["result"], wall_ms, dict(wall_ms=wall_ms, device_ms=busy_ms,
                                         aten_calls=n_ops)


def cold_start_phase(sc: Scene, knn_cuda) -> int:
    """An unseeded Tracker under IcpConfig(fused_gn=True): init on frame 0,
    tracking on frames 1-4, then a forced re-init; returns K3's launches."""
    import dataclasses

    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    cfg = dataclasses.replace(sc.cfg, icp=dataclasses.replace(sc.cfg.icp,
                                                               fused_gn=True))
    tracker = Tracker(Estimator(sc.obj, sc.hand, cfg), seed=0)
    limit = 0.1 * 1000.0 * sc.obj.diameter
    reset_counts(knn_cuda)
    adds, ms, per_frame = [], [], []
    for i in range(5):
        before = counts(knn_cuda)
        res, t, a = sc.step(tracker, f"cold-start frame {i}")
        after = counts(knn_cuda)
        per_frame.append({k: after[k] - before[k] for k in after})
        adds.append(a)
        ms.append(t)
        check(res.reinitialized == (i == 0),
              f"cold-start frame {i}: reinitialized={res.reinitialized}")
        check(per_frame[-1]["K3"] > 0, f"cold-start frame {i} never launched K3")
    check(adds[0] < limit or adds[1] < limit,
          f"init missed: ADD-S {adds[0]:.3f} / {adds[1]:.3f} mm, limit {limit:.3f} mm")
    check(max(adds[2:]) < 5.0, f"tracked frames 2-4 ADD-S {adds[2:]} >= 5 mm")
    print(f"cold start: init frame {ms[0]:.2f} ms, tracked frames 1-4 "
          f"{sum(ms[1:]) / 4:.2f} ms/frame; launches, init frame "
          f"{per_frame[0]}, each tracked frame {per_frame[1:]}", flush=True)
    tracker.state = tracker.state._replace(fitness=0.0)
    res, t, a = sc.step(tracker, "profiled forced re-init", profiled=True)
    check(res.reinitialized, "the forced watchdog did not re-initialise")
    n = counts(knn_cuda)
    print(f"cold-start path launches (5 frames + forced re-init): {n}", flush=True)
    check_shapes(knn_cuda, "cold-start path")
    return n["K3"]


def nn_fn_phase(sc: Scene, knn_cuda) -> int:
    """Three tracked frames through Estimator(nn_fn=K2) from the ground
    truth; returns K2's launches."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    tracker = Tracker(Estimator(sc.obj, sc.hand, sc.cfg,
                                nn_fn=knn_cuda.make_nn_fn()), seed=0)
    tracker.state = tracker.state._replace(pose=sc.pose_gt, initialized=True,
                                           fitness=1.0)
    reset_counts(knn_cuda)
    ms = []
    for i in range(3):
        res, t, a = sc.step(tracker, f"nn_fn frame {i}")
        ms.append(t)
        check(not res.reinitialized, f"nn_fn frame {i} re-initialized")
        check(a < 5.0, f"nn_fn frame {i}: ADD-S {a:.3f} mm >= 5 mm")
    n = counts(knn_cuda)
    check(n["K2"] > 0 and n["K1"] == 0, f"nn_fn path launches {n}")
    print(f"nn_fn path: {sum(ms[1:]) / 2:.2f} ms/frame (frames 1-2), "
          f"launches in 3 frames {n}", flush=True)
    check_shapes(knn_cuda, "nn_fn path")
    return n["K2"]


def sequence_phase(knn_cuda, dev, work: str) -> dict:
    """`cli demo` at VGA with 512 particles, then `cli eval` on its output;
    returns what the later phases need (sequence directory, camera, mesh,
    dense cloud, the tracked frames' mean ms)."""
    import numpy as np
    import torch

    from icra20_hand_object_pose_tpu_torch import cli, evaluation, parity
    from icra20_hand_object_pose_tpu_torch.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu_torch.datasets.sequence import RecordedSequence
    from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
    from icra20_hand_object_pose_tpu_torch.ops import render
    from icra20_hand_object_pose_tpu_torch.utils import meshio

    n_frames = DEMO["frames"]
    out = os.path.join(work, "demo")
    reset_counts(knn_cuda)
    rc = cli.main(["demo", "--out", out]
                  + [a for k, v in DEMO.items() for a in (f"--{k}", str(v))])
    n = counts(knn_cuda)
    check(rc == 0, f"cli demo returned {rc}")
    check(n["K1"] > 0 and n["K2"] == 0 and n["K3"] == 0,
          f"sequence path launches {n}: K1 must carry it alone")
    check_shapes(knn_cuda, "sequence path")
    seq_dir = os.path.join(out, "sequence")
    promised = ["metrics.jsonl", "summary.json", "sequence/cam_K.txt",
                "sequence/meta.json"]
    for i in range(n_frames):
        promised += [f"poses/{i:06d}.txt"] + [
            f"sequence/{sub}/{i:06d}.{ext}" for sub, ext in (
                ("depth", "png"), ("rgb", "png"), ("pose_gt", "txt"),
                ("hand_base", "txt"), ("hand_q", "txt"))]
    missing = [p for p in promised if not os.path.exists(os.path.join(out, p))]
    check(not missing, f"cli demo did not write {missing}")

    # the same sequence again (one seed, one device): what was saved must
    # read back within half a 16-bit depth unit of what was generated
    mesh = meshio.make_test_object("box")
    seq = RecordedSequence(seq_dir)
    cam = seq.camera
    check((cam.width, cam.height) == (DEMO["width"], DEMO["height"])
          and abs(cam.fx - 0.9 * DEMO["width"]) < 1e-3, f"camera {cam}")
    hand = make_t42_hand(device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = generate_sequence(
        mesh, hand, SyntheticSequenceConfig(n_frames=n_frames, camera=cam),
        device=dev)
    gen_ms = 1000.0 * (time.perf_counter() - t0) / n_frames
    check(len(seq) == n_frames, f"{len(seq)} frames read back")
    native_phase(seq_dir, n_frames)
    converter_check(seq_dir, n_frames, work)
    for fr, rec in zip(frames, seq):
        err = float(np.abs(rec.depth - fr.depth).max())
        check(err <= 0.5 * cam.depth_scale + 1e-6,
              f"frame {rec.index}: depth round trip off by {err:.6f} m")
        check(float(np.abs(rec.pose_gt - fr.pose_gt).max()) < 1e-6
              and float(np.abs(rec.hand_base - fr.hand_base).max()) < 1e-6,
              f"frame {rec.index}: poses read back differ")
        check(rec.rgb is not None and bool((rec.rgb == fr.rgb).all()),
              f"frame {rec.index}: rgb read back differs")
    cover = float(np.mean(frames[0].depth > 0))
    check(0.01 < cover < 0.5, f"frame 0 covers {cover:.3f} of the image")
    scene = mesh.transformed(frames[0].pose_gt).merged(
        hand.merged_mesh(np.asarray([0.5, 0.5], np.float32)).transformed(
            frames[0].hand_base))
    verts = torch.as_tensor(np.asarray(scene.vertices, np.float32), device=dev)
    faces = torch.as_tensor(np.asarray(scene.faces, np.int64), device=dev)
    raster_ms = time_ms(lambda: render.raster_depth(
        verts, faces, fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
        height=cam.height, width=cam.width), 3)
    print(f"sequence: raster_depth {raster_ms:.2f} ms/frame on the card "
          f"({faces.shape[0]} faces at {cam.width}x{cam.height}), "
          f"generate_sequence {gen_ms:.2f} ms/frame incl. host noise and "
          f"shading, frame 0 covers {100 * cover:.1f}% of the image", flush=True)

    recs = [json.loads(line) for line in open(os.path.join(out, "metrics.jsonl"))]
    check(len(recs) == n_frames, f"{len(recs)} metric records")
    reinit = [bool(r["reinitialized"]) for r in recs]
    check(reinit == [True] + [False] * (n_frames - 1), f"re-inits {reinit}")
    dense, _ = mesh.sample_surface(8192, seed=123)
    poses = parity.load_pose_dump(os.path.join(out, "poses"))
    adds = [1000.0 * evaluation.add_s_error(p, fr.pose_gt, dense)
            for p, fr in zip(poses, frames)]
    check(all(np.isfinite(p).all() and p.shape == (4, 4) for p in poses),
          "a pose is not finite")
    limit = 0.1 * 1000.0 * mesh.diameter()
    check(adds[0] < limit or adds[1] < limit,
          f"init missed: ADD-S {adds[0]:.3f} / {adds[1]:.3f} mm, limit {limit:.3f} mm")
    check(max(adds[2:]) < 5.0, f"tracked frames 2-7 ADD-S {adds[2:]} >= 5 mm")
    ms = [r["ms"] for r in recs]
    track_ms = sum(ms[1:]) / (n_frames - 1)
    print(f"sequence: init frame {ms[0]:.2f} ms, frames 1-7 {track_ms:.2f} "
          f"ms/frame; ADD-S mm per frame {[round(a, 3) for a in adds]}; "
          f"launches in 8 frames {n}", flush=True)

    mesh_path = os.path.join(work, "box.obj")
    meshio.save_obj(mesh, mesh_path)
    rc = cli.main(["eval", "--poses", os.path.join(out, "metrics.jsonl"),
                   "--data", seq_dir, "--object", mesh_path,
                   "--ref-poses", os.path.join(out, "poses"),
                   "--device", str(dev)])
    check(rc == 0, f"cli eval returned {rc}")
    rep = parity.compare_pose_sequences(
        parity.load_pose_dump(os.path.join(out, "metrics.jsonl")), poses, dense)
    check(rep.identical and rep.n_identical == n_frames,
          f"a dump against itself is not identical: {rep}")
    return dict(seq=seq, mesh=mesh, hand=hand, dense=dense, poses=poses,
                track_ms=track_ms)


def native_phase(seq_dir: str, n_frames: int) -> None:
    """The sequence read through the native loader (use_native=True), by
    index and by its prefetching iterator, against the Python codec
    (use_native=False): depths bitwise equal; each decoder's ms per frame
    of depth decode alone."""
    import numpy as np

    from icra20_hand_object_pose_tpu_torch import native
    from icra20_hand_object_pose_tpu_torch.datasets.sequence import RecordedSequence
    from icra20_hand_object_pose_tpu_torch.utils import pngio

    t0 = time.perf_counter()
    nat = RecordedSequence(seq_dir, use_native=True)   # builds the loader
    build_s = time.perf_counter() - t0
    py = RecordedSequence(seq_dir, use_native=False)
    streamed = list(nat)
    check(len(streamed) == n_frames, f"the native iterator gave {len(streamed)} frames")
    for i, fr in enumerate(streamed):
        ref = py[i]
        check(fr.index == i and np.array_equal(fr.depth, ref.depth)
              and np.array_equal(nat[i].depth, ref.depth),
              f"frame {i}: the native loader's depth differs from the codec's")
    files = nat._depth_files
    decode_ms = {}
    for name, read in (("native", native.read_png16), ("python", pngio.read_png_gray)):
        t0 = time.perf_counter()
        for path in files:
            read(path)
        decode_ms[name] = 1000.0 * (time.perf_counter() - t0) / len(files)
    print(f"native loader: built or loaded in {build_s:.2f} s; {n_frames} depths "
          f"bitwise the Python codec's (by index and prefetched); decode "
          f"{decode_ms['native']:.3f} ms/frame native, {decode_ms['python']:.3f} "
          f"ms/frame Python", flush=True)


def converter_check(seq_dir: str, n_frames: int, work: str) -> None:
    """Phase 7's sequence copied into the released layout (renumbered from
    7, poses under annotated_poses/, hand bases under hand_pose/),
    converted by scripts/convert_reference_dataset.py, read through the
    port with use_native=True and False: depths, rgb, poses, hand bases and
    joint angles bitwise what phase 7 wrote."""
    import shutil

    import numpy as np

    from icra20_hand_object_pose_tpu_torch.datasets.sequence import RecordedSequence

    src = os.path.join(work, "released")
    for ours, released, ext in (("depth", "depth", "png"), ("rgb", "rgb", "png"),
                                ("pose_gt", "annotated_poses", "txt"),
                                ("hand_base", "hand_pose", "txt"),
                                ("hand_q", "hand_q", "txt")):
        os.makedirs(os.path.join(src, released))
        for i in range(n_frames):
            shutil.copyfile(os.path.join(seq_dir, ours, f"{i:06d}.{ext}"),
                            os.path.join(src, released, f"{i + 7:06d}.{ext}"))
    shutil.copyfile(os.path.join(seq_dir, "cam_K.txt"), os.path.join(src, "cam_K.txt"))
    dst = os.path.join(work, "converted")
    check(_script("convert_reference_dataset").convert(src, dst) == n_frames,
          "the converter did not convert every frame")
    written = RecordedSequence(seq_dir, use_native=False)
    for use_native in (True, False):
        seq = RecordedSequence(dst, use_native=use_native)
        check(len(seq) == n_frames, f"{len(seq)} converted frames read back")
        for i in range(n_frames):
            a, b = seq[i], written[i]
            check(all(np.array_equal(getattr(a, k), getattr(b, k)) for k in (
                "depth", "rgb", "pose_gt", "hand_base", "hand_q")),
                f"converted frame {i} (use_native={use_native}) differs from phase 7's")
    print(f"converter: {n_frames} frames in the released layout, converted by "
          f"scripts/convert_reference_dataset.py, read through the port (native "
          f"and Python) bitwise what phase 7 wrote", flush=True)


def _demo_estimator(sq: dict, dev, **score):
    """The Estimator that `cli demo` built for the sequence (with fields of
    its ScoreConfig replaced by `score`)."""
    import argparse
    import dataclasses

    from icra20_hand_object_pose_tpu_torch import cli
    from icra20_hand_object_pose_tpu_torch.models import Estimator, ObjectModel

    _, cfg = cli.demo_config(argparse.Namespace(**{"config": None, **DEMO}))
    cfg = dataclasses.replace(cfg, score=dataclasses.replace(cfg.score, **score))
    obj = ObjectModel(sq["mesh"], model_points=cfg.model_points, device=dev)
    return Estimator(obj, sq["hand"], cfg)


def checkpoint_phase(sq: dict, knn_cuda, dev, work: str) -> None:
    """Frames 0-3 from a cold start, save; a second Tracker loads and both
    track frames 4-7: bitwise equal poses."""
    import numpy as np
    import torch

    from icra20_hand_object_pose_tpu_torch.models import Tracker

    est = _demo_estimator(sq, dev)
    seq = sq["seq"]
    path = os.path.join(work, "tracker_ckpt")
    reset_counts(knn_cuda)
    whole, poses = Tracker(est), []
    for i in range(len(seq)):
        fr = seq[i]
        poses.append(whole.step(fr.depth, fr.hand_base, fr.hand_q).pose)
        if i == 3:
            whole.save(path)
    resumed = Tracker(est, seed=1)
    resumed.load(path)
    check(resumed.state.frame_idx == 4 and resumed.state.pose.device == poses[0].device,
          f"loaded state {resumed.state.frame_idx} on {resumed.state.pose.device}")
    for i in range(4, len(seq)):
        fr = seq[i]
        out = resumed.step(fr.depth, fr.hand_base, fr.hand_q)
        check(out.frame_idx == i and not out.reinitialized,
              f"resumed frame {i}: idx {out.frame_idx}, reinit {out.reinitialized}")
        check(bool(torch.equal(out.pose, poses[i])),
              f"resumed frame {i} differs from the uninterrupted run")
    check(all(np.array_equal(p.cpu().numpy(), q.astype(np.float32))
              for p, q in zip(poses, sq["poses"])),
          "the run through the API does not repeat the command line's poses")
    print(f"checkpoint: frames 4-7 of the resumed Tracker bitwise equal to the "
          f"uninterrupted run; the run repeats the command line's poses "
          f"bitwise; launches {counts(knn_cuda)}", flush=True)
    # the default configuration's init program once more, profiled: a forced
    # watchdog on the last frame
    before = counts(knn_cuda)
    whole.state = whole.state._replace(fitness=0.0)
    last = seq[len(seq) - 1]
    res, _, _ = timed_step(whole, last, last.pose_gt, sq["dense"],
                           "profiled default-config re-init", profiled=True)
    check(res.reinitialized, "the forced watchdog did not re-initialise")
    after = counts(knn_cuda)
    print(f"default-config init frame launches "
          f"{ {k: after[k] - before[k] for k in after} }", flush=True)
    check_shapes(knn_cuda, "checkpoint path")


def pixel_phase(sq: dict, knn_cuda, dev) -> None:
    """Three tracked frames of the sequence from the ground truth under
    ScoreConfig(mode="pixel")."""
    import torch

    from icra20_hand_object_pose_tpu_torch.models import Tracker

    seq = sq["seq"]
    tracker = Tracker(_demo_estimator(sq, dev, mode="pixel"))
    tracker.state = tracker.state._replace(pose=seq[0].pose_gt, initialized=True,
                                           fitness=1.0)
    reset_counts(knn_cuda)
    torch.cuda.reset_peak_memory_stats()
    ms, adds = [], []
    for i in range(3):
        out, t, a = timed_step(tracker, seq[i], seq[i].pose_gt, sq["dense"],
                               f"pixel-mode frame {i}")
        ms.append(t)
        adds.append(a)
        check(not out.reinitialized, f"pixel-mode frame {i} re-initialized")
        check(a < 5.0, f"pixel-mode frame {i}: ADD-S {a:.3f} mm >= 5 mm")
    n = counts(knn_cuda)
    check(n["K1"] > 0, "the pixel-mode frames never launched K1")
    print(f"pixel mode: {sum(ms[1:]) / 2:.2f} ms/frame (frames 1-2; frame 0 "
          f"{ms[0]:.2f} ms) beside point mode's {sq['track_ms']:.2f} ms/frame; "
          f"ADD-S mm {[round(a, 3) for a in adds]}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches {n}",
          flush=True)
    timed_step(tracker, seq[3], seq[3].pose_gt, sq["dense"],
               "profiled pixel-mode frame", profiled=True)
    check_shapes(knn_cuda, "pixel-mode path")


class Library:
    """BASELINE config 5 on the card: `n` objects (LIB by default) at config
    3's sizes (VGA, 2048 scene / 1024 model / 2048 render points, 512
    particles x 10 iterations, T42 hand), object i built with
    ObjectModel(mesh, seed=i), one splat-rendered frame per object with
    1 mm noise. `shapes` cycles over the library."""

    def __init__(self, sc: Scene, dev, shapes, n: int = LIB):
        import numpy as np

        from icra20_hand_object_pose_tpu_torch.datasets import render_frame_fast
        from icra20_hand_object_pose_tpu_torch.models import ObjectModel
        from icra20_hand_object_pose_tpu_torch.utils import meshio

        self.sc, self.dev, self.n = sc, dev, n
        self.shapes = [shapes[i % len(shapes)] for i in range(n)]
        self.meshes = [meshio.make_test_object(s) for s in self.shapes]
        self.objs = [ObjectModel(m, model_points=1024, render_points=2048, seed=i,
                                 device=dev) for i, m in enumerate(self.meshes)]
        self.depths = np.stack([
            render_frame_fast(m, sc.pose_gt, sc.hand, sc.hand_base, sc.hand_q,
                              sc.cam, noise_sigma=0.001,
                              rng=np.random.default_rng(i), device="cpu")
            for i, m in enumerate(self.meshes)])
        self.hand_bases = np.stack([sc.hand_base] * n)
        self.hand_qs = np.stack([sc.hand_q] * n)
        self.dense = [m.sample_surface(8192, seed=123)[0] for m in self.meshes]
        self.limits = [0.1 * 1000.0 * o.diameter for o in self.objs]

    def sweep(self, cfg=None, **kw):
        from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep

        return LibrarySweep(self.objs, self.sc.hand, cfg or self.sc.cfg, **kw)

    def seeded(self, sweep):
        """A state at the ground truth, as a healthy tracked frame leaves it."""
        import torch

        st = sweep.init_state()
        gt = torch.as_tensor(self.sc.pose_gt, dtype=torch.float32, device=self.dev)
        return st._replace(poses=gt.repeat(self.n, 1, 1),
                           prev_poses=gt.repeat(self.n, 1, 1),
                           initialized=torch.ones_like(st.initialized),
                           fitness=torch.ones_like(st.fitness))

    def step(self, sweep, st, label: str, profiled: bool = False, shared=False,
             frames=None):
        """One LibrarySweep.step on the static frames (or on `frames`, one
        SyntheticFrame per object, against their ground truth), timed to the
        poses on the host (under torch.profiler when `profiled`); returns
        (state, result, ms, ADD-S mm per object, the profile's numbers or
        None)."""
        import numpy as np

        from icra20_hand_object_pose_tpu_torch import evaluation

        if frames is not None:
            args = tuple(np.stack([getattr(f, k) for f in frames])
                         for k in ("depth", "hand_base", "hand_q"))
            gts = [f.pose_gt for f in frames]
        else:
            args = ((self.depths[0], self.hand_bases[0], self.hand_qs[0]) if shared
                    else (self.depths, self.hand_bases, self.hand_qs))
            gts = [self.sc.pose_gt] * self.n

        def run():
            st1, res = sweep.step(st, *args)
            return st1, res, res.poses.cpu().numpy()

        (st, res, poses), ms, prof_numbers = timed_call(run, self.dev, profiled)
        check(poses.shape == (self.n, 4, 4) and bool(np.isfinite(poses).all()),
              f"{label}: poses not finite")
        adds = [1000.0 * evaluation.add_s_error(poses[o], gts[o], self.dense[o])
                for o in range(self.n)]
        print(f"{label}: {ms:.2f} ms, ADD-S mm {[round(a, 3) for a in adds]}, "
              f"reinitialized {res.reinitialized.tolist()}, fitness "
              f"{[round(f, 4) for f in res.fitness.tolist()]}", flush=True)
        return st, res, ms, adds, prof_numbers


def check_grouped(knn_cuda, kernel: str, path: str, n: int = LIB) -> None:
    """Every launch of `kernel` since the last reset took one query (scene)
    block per object or one for all: `n` (the library's objects) or 1
    blocks, never one launch per object."""
    shapes = {"K1": knn_cuda.nn_gather_batched, "K2": knn_cuda.nn_batched,
              "K3": knn_cuda.nn_gn_batched}[kernel].shapes
    check(bool(shapes), f"{path} never launched {kernel}")
    bad = [s for s in shapes if s[0] % n or s[1] not in (1, n)]
    check(not bad, f"{path} launched {kernel} per object, not per library: {bad}")


def library_phase(sc: Scene, knn_cuda, dev, single: dict | None) -> dict:
    """Phase 10: LibrarySweep per scene at full width: an init step from
    init_state(), 3 tracked steps, one tracked step under torch.profiler,
    and the 8-frame `_scene_prep` loop alone under torch.profiler. Returns
    the library (for the next phases), K1's launches, the results of steps
    0 and 1 (phase 14 repeats them), the tracked ms/step and the state
    after step 3 (phase 15's mixed step starts from it)."""
    import torch

    from icra20_hand_object_pose_tpu_torch.models.estimator import _generator
    from icra20_hand_object_pose_tpu_torch.utils.profiling import profile_counts

    lib = Library(sc, dev, LIB_MESHES)
    sweep = lib.sweep()
    st = sweep.init_state()
    thr = sc.cfg.tracker.fitness_reinit_threshold
    reset_counts(knn_cuda)
    torch.cuda.reset_peak_memory_stats()
    ms, adds, fitness, results = [], [], [], []
    for i in range(4):
        st, res, t, a, _ = lib.step(sweep, st, f"library step {i}")
        results.append(res)
        ms.append(t)
        adds.append(a)
        reinit = res.reinitialized.tolist()
        if i == 0:
            check(all(reinit), f"library step 0 re-initialized {reinit}, not all")
        else:
            healthy = [f >= thr for f in fitness[-1]]
            check(not any(r and h for r, h in zip(reinit, healthy)),
                  f"library step {i} re-initialized a healthy object: {reinit}, "
                  f"fitness before {fitness[-1]}")
        fitness.append(res.fitness.tolist())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n = counts(knn_cuda)
    for o in range(LIB):
        check(adds[0][o] < lib.limits[o] or adds[1][o] < lib.limits[o],
              f"library init missed object {o} ({lib.shapes[o]}): ADD-S "
              f"{adds[0][o]:.3f} / {adds[1][o]:.3f} mm, limit {lib.limits[o]:.3f} mm")
        late = [adds[i][o] for i in (2, 3)]
        check(max(late) < 5.0, f"library object {o} ({lib.shapes[o]}): tracked "
              f"steps 2-3 ADD-S {late} >= 5 mm")
    check(n["K1"] > 0 and n["K2"] == 0 and n["K3"] == 0,
          f"library path launches {n}: K1 must carry it alone")
    check_grouped(knn_cuda, "K1", "library path")
    step_ms = sum(ms[2:]) / 2
    print(f"LibrarySweep.step, {LIB} objects x 512 particles: init step "
          f"{ms[0]:.2f} ms, tracked {step_ms:.2f} ms/step (steps 2-3; step 1 "
          f"{ms[1]:.2f} ms) = {step_ms / LIB:.2f} ms per object-frame, "
          f"{1000.0 * LIB / step_ms:.2f} object-frames/s, "
          f"{1000.0 * LIB * 512 * 10 / step_ms:.0f} hypotheses/s; peak device "
          f"memory {peak:.2f} GiB; launches in 4 steps {n}", flush=True)
    _, _, _, _, prof = lib.step(sweep, st, "profiled library step", profiled=True)
    if single is not None:
        print(f"beside the same run's single frame: {step_ms:.2f} ms/step vs "
              f"{single['frame_ms']:.2f} ms/frame ({step_ms / single['frame_ms']:.2f}x "
              f"for {LIB}x the objects); profiled: {prof['aten_calls']} ATen calls vs "
              f"{single['aten_calls']} ({prof['aten_calls'] / single['aten_calls']:.2f}x), "
              f"device {prof['device_ms']:.3f} ms vs {single['device_ms']:.3f} ms "
              f"({prof['device_ms'] / single['device_ms']:.2f}x)", flush=True)
        check(prof["aten_calls"] < 4 * single["aten_calls"],
              f"a sweep step issued {prof['aten_calls']} ATen calls, not far "
              f"fewer than {LIB}x the single frame's {single['aten_calls']}")
    # the per-frame scene prep loop of a tracked step, alone
    est = sweep._est
    gens = [_generator(o, dev) for o in range(LIB)]

    @torch.no_grad()
    def prep_loop():
        for o in range(LIB):
            est._scene_prep(gens[o], est._tensor(lib.depths[o]),
                            est._tensor(lib.hand_bases[o]),
                            est._tensor(lib.hand_qs[o]), False)

    pr = profile_counts(prep_loop, device=dev)
    prep_ms, prep_ops = pr["wall_ms"], pr["aten_calls"]
    print(f"scene prep loop alone ({LIB} frames, profiled): {prep_ms:.2f} ms, "
          f"{prep_ops} ATen calls = {100.0 * prep_ms / prof['wall_ms']:.1f}% of the "
          f"profiled step's wall time, {100.0 * prep_ops / prof['aten_calls']:.1f}% "
          f"of its ATen calls", flush=True)
    check_shapes(knn_cuda, "library path")
    return dict(lib=lib, launches=n["K1"], steps=results[:2], step_ms=step_ms,
                state=st)


def shared_phase(sc: Scene, knn_cuda, dev) -> None:
    """Phase 11: the shared-scene library: LIB models of the box, one frame:
    an init step and 2 tracked steps; object 0's init result bitwise the
    per-scene path's fed LIB copies of the frame with the same seeds."""
    import numpy as np
    import torch

    lib = Library(sc, dev, ["box"])
    shared, per = lib.sweep(shared_scene=True), lib.sweep()
    st = shared.init_state()
    reset_counts(knn_cuda)
    ms = []
    for i in range(3):
        st, res, t, adds, _ = lib.step(shared, st, f"shared-scene step {i}", shared=True)
        ms.append(t)
        check(all(res.reinitialized.tolist()) == (i == 0) and
              any(res.reinitialized.tolist()) == (i == 0),
              f"shared-scene step {i}: reinitialized {res.reinitialized.tolist()}")
        if i > 0:
            check(max(adds) < 5.0, f"shared-scene step {i}: ADD-S {adds} >= 5 mm")
    check_grouped(knn_cuda, "K1", "shared-scene path")
    print(f"shared scene: init step {ms[0]:.2f} ms, tracked {sum(ms[1:]) / 2:.2f} "
          f"ms/step; launches in 3 steps {counts(knn_cuda)}", flush=True)
    keys = list(range(40, 40 + LIB))
    prev = np.stack([np.eye(4, dtype=np.float32)] * LIB)
    out_sh = shared._run(keys, lib.depths[0], prev, lib.hand_bases[0],
                         lib.hand_qs[0], "init")
    out_per = per._run(keys, np.stack([lib.depths[0]] * LIB), prev, lib.hand_bases,
                       lib.hand_qs, "init")
    check(bool(torch.equal(out_sh.pose[0], out_per.pose[0])
               and torch.equal(out_sh.fitness[0], out_per.fitness[0])
               and torch.equal(out_sh.coverage[0], out_per.coverage[0])),
          "shared-scene object 0 differs from the per-scene path on the same frame")
    print("shared scene: object 0's init result bitwise equal to the per-scene "
          "path fed 8 copies of the frame", flush=True)
    check_shapes(knn_cuda, "shared-scene path")


def library_kernels_phase(lb: dict, sc: Scene, knn_cuda, dev, work: str) -> dict:
    """Phase 12: a tracked sweep step through K2 (nn_fn) and one through K3
    (fused_gn), both from the ground truth; save_state / load_state with
    the next step bitwise equal; `cli sweep` on two recorded sequences."""
    import dataclasses

    import numpy as np
    import torch

    from icra20_hand_object_pose_tpu_torch import cli
    from icra20_hand_object_pose_tpu_torch.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu_torch.datasets.sequence import save_sequence
    from icra20_hand_object_pose_tpu_torch.utils import meshio

    lib = lb["lib"]
    launches = {}
    fused = dataclasses.replace(sc.cfg, icp=dataclasses.replace(sc.cfg.icp, fused_gn=True))
    for kernel, sweep in (("K2", lib.sweep(nn_fn=knn_cuda.make_nn_fn())),
                          ("K3", lib.sweep(cfg=fused))):
        reset_counts(knn_cuda)
        st, res, _, adds, _ = lib.step(sweep, lib.seeded(sweep), f"library step through {kernel}")
        n = counts(knn_cuda)
        check(not any(res.reinitialized.tolist()), f"{kernel} sweep step re-initialized")
        check(max(adds) < 5.0, f"{kernel} sweep step: ADD-S {adds} >= 5 mm")
        check(n[kernel] > 0 and (kernel != "K2" or n["K1"] == 0),
              f"{kernel} sweep path launches {n}")
        check_grouped(knn_cuda, kernel, f"{kernel} sweep path")
        check_shapes(knn_cuda, f"{kernel} sweep path")
        launches[kernel] = n[kernel]
    # checkpoint: the K3 sweep's state after that step, into a second sweep
    path = os.path.join(work, "sweep_state")
    sweep.save_state(st, path)
    other = lib.sweep(cfg=fused)
    st2 = other.load_state(path)
    check(st2.frame_idx == 1 and st2.key == st.key and st2.poses.device == st.poses.device,
          f"loaded sweep state: frame {st2.frame_idx} on {st2.poses.device}")
    _, res_a, _, _, _ = lib.step(sweep, st, "library step, uninterrupted")
    _, res_b, _, _, _ = lib.step(other, st2, "library step, resumed")
    check(all(torch.equal(a, b) for a, b in zip(res_a, res_b) if a is not None),
          "the resumed sweep's step differs from the uninterrupted one")
    print("sweep checkpoint: the resumed step bitwise equal to the uninterrupted one",
          flush=True)
    # the command line on two recorded sequences
    shapes, n_frames = ["box", "cylinder"], 3
    argv = ["sweep", "--out", os.path.join(work, "sweep"), "--device", str(dev)]
    for s in shapes:
        mesh = meshio.make_test_object(s)
        frames = generate_sequence(
            mesh, sc.hand, SyntheticSequenceConfig(n_frames=n_frames, camera=sc.cam),
            device=dev)
        save_sequence(frames, sc.cam, os.path.join(work, f"seq_{s}"))
        meshio.save_obj(mesh, os.path.join(work, f"{s}.obj"))
        argv += ["--data", os.path.join(work, f"seq_{s}"),
                 "--object", os.path.join(work, f"{s}.obj")]
    reset_counts(knn_cuda)
    rc = cli.main(argv)
    check(rc == 0, f"cli sweep returned {rc}")
    recs = [json.loads(line) for line in open(os.path.join(work, "sweep", "metrics.jsonl"))]
    check(len(recs) == n_frames and all(len(r["add_s"]) == 2 for r in recs),
          f"cli sweep wrote {len(recs)} records")
    check(recs[0]["reinitialized"] == [True, True], f"cli sweep frame 0: {recs[0]}")
    for o in range(2):
        for i in range(n_frames):
            pose = np.loadtxt(os.path.join(work, "sweep", f"obj{o:02d}_poses", f"{i:06d}.txt"))
            check(pose.shape == (4, 4) and bool(np.isfinite(pose).all()),
                  f"cli sweep pose of object {o}, frame {i}")
    print(f"cli sweep: {n_frames} frames x 2 objects, ms/frame "
          f"{[round(r['ms'], 1) for r in recs]}, ADD-S mm "
          f"{[[round(1000 * a, 2) for a in r['add_s']] for r in recs]}, "
          f"launches {counts(knn_cuda)}", flush=True)
    return launches


def arrays(res) -> dict:
    """A result's tensors (None fields left out) as host arrays."""
    return {k: v.cpu().numpy() for k, v in res._asdict().items() if v is not None}


def same(a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(
        a[k].shape == b[k].shape and (a[k] == b[k]).all() for k in a)


def add_launches(a: dict, b: dict) -> dict:
    return {k: a[k] + b[k] for k in a}


def mesh_local_phase(sc: Scene, lb: dict, knn_cuda, dev, single: dict | None) -> dict:
    """Phase 14 (a): a process group of one over NCCL. Three tracked frames
    of Estimator(mesh=make_mesh(1)) from the ground truth (the search's
    stream is folded with the rank, so not phase 4's poses), then the
    object mesh's sweep: its init and track steps bitwise phase 10's.
    Returns each kernel's launches in both."""
    import torch
    import torch.distributed as dist

    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
    from icra20_hand_object_pose_tpu_torch.parallel import make_mesh
    from icra20_hand_object_pose_tpu_torch.parallel.mesh import free_port

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        tracker = Tracker(Estimator(sc.obj, sc.hand, sc.cfg, mesh=make_mesh(1)), seed=0)
        tracker.state = tracker.state._replace(pose=sc.pose_gt, initialized=True,
                                               fitness=1.0)
        reset_counts(knn_cuda)
        ms = []
        for i in range(3):
            res, t, a = sc.step(tracker, f"mesh of one, frame {i}")
            ms.append(t)
            check(not res.reinitialized and a < 5.0,
                  f"mesh of one, frame {i}: reinit {res.reinitialized}, ADD-S {a:.3f} mm")
        frame = counts(knn_cuda)
        k1 = frame["K1"]
        check(k1 > 0, "the mesh-of-one frames never launched K1")
        check_shapes(knn_cuda, "mesh-of-one frame path")
        lib = lb["lib"]
        sweep = lib.sweep(mesh=make_mesh(1, "obj"))
        reset_counts(knn_cuda)
        st, sweep_ms = sweep.init_state(), []
        for i, ref in enumerate(lb["steps"]):
            st, res, t, _, _ = lib.step(sweep, st, f"mesh-of-one library step {i}")
            sweep_ms.append(t)
            check(same(arrays(res), arrays(ref)),
                  f"the mesh-of-one sweep's step {i} differs from phase 10's")
        n = counts(knn_cuda)
        check(n["K1"] > 0, "the mesh-of-one sweep never launched K1")
        check_shapes(knn_cuda, "mesh-of-one library path")
        beside = (f" beside phase 4's {single['frame_ms']:.2f} ms/frame" if single else "")
        print(f"mesh of one (NCCL): Tracker.step {sum(ms[1:]) / 2:.2f} ms/frame "
              f"(frames 1-2){beside}; sweep init step {sweep_ms[0]:.2f} ms, track "
              f"step {sweep_ms[1]:.2f} ms beside phase 10's {lb['step_ms']:.2f} "
              f"ms/step, both bitwise phase 10's; launches {frame} + {n}",
              flush=True)
        return add_launches(frame, n)
    finally:
        dist.destroy_process_group()


def _mesh_cases(rank: int, world: int, port: int, backend: str) -> dict:
    """Phase 14 (b)/(c) on one rank: the split swarm's frames, the object
    mesh's init and track steps, the (1, world) mesh's tracked step; each
    with its results as host arrays, its ms and its launches by shape."""
    import datetime

    import torch
    import torch.distributed as dist

    from icra20_hand_object_pose_tpu_torch.models import Estimator
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
    from icra20_hand_object_pose_tpu_torch.parallel import make_mesh

    dev = torch.device("cuda", rank if backend == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        sc = Scene(dev)
        lib = Library(sc, dev, LIB_MESHES)
        out = {}
        est = Estimator(sc.obj, sc.hand, sc.cfg, mesh=make_mesh(world, "p"))
        reset_counts(knn_cuda)
        results, ms = [], []
        for i in range(2):
            res, t, _ = timed_call(lambda: est.estimate(
                sc.depth, sc.pose_gt, sc.hand_base, sc.hand_q, key=i), dev)
            results.append(arrays(res))
            ms.append(t)
        out["frame"] = dict(results=results, ms=ms, launches=launched(knn_cuda))
        sweep = lib.sweep(mesh=make_mesh(world, "obj"))
        reset_counts(knn_cuda)
        st, results, ms = sweep.init_state(), [], []
        for i in range(2):
            (st, res), t, _ = timed_call(lambda: sweep.step(
                st, lib.depths, lib.hand_bases, lib.hand_qs), dev)
            results.append(arrays(res))
            ms.append(t)
        out["sweep"] = dict(results=results, ms=ms, launches=launched(knn_cuda))
        sweep = lib.sweep(mesh=make_mesh((1, world), ("obj", "p")), particle_axis="p")
        reset_counts(knn_cuda)
        (_, res), t, _ = timed_call(lambda: sweep.step(
            lib.seeded(sweep), lib.depths, lib.hand_bases, lib.hand_qs), dev)
        out["sweep_2d"] = dict(results=[arrays(res)], ms=[t], launches=launched(knn_cuda))
        return out
    finally:
        dist.destroy_process_group()


def mesh_ranks_phase(sc: Scene, lb: dict, knn_cuda, single: dict | None,
                     backend: str) -> dict:
    """Phase 14 (b) (gloo: two ranks on this card) or (c) (NCCL: a card a
    rank): two spawned ranks run `_mesh_cases` (parallel.spawn_ranks: a
    rank that fails or sends nothing in 600 s fails the phase, and both
    are stopped). Checks the results (module docstring) and every rank's
    launch shapes; returns each kernel's launches on both ranks."""
    import numpy as np

    from icra20_hand_object_pose_tpu_torch import evaluation
    from icra20_hand_object_pose_tpu_torch.parallel import spawn_ranks

    world, tag = 2, "(b) gloo, one card" if backend == "gloo" else "(c) NCCL, a card each"
    got = dict(enumerate(spawn_ranks(_mesh_cases, world, (backend,), timeout=600)))
    r0, r1 = got[0], got[1]
    for i, (a, b) in enumerate(zip(r0["frame"]["results"], r1["frame"]["results"])):
        check(same(a, b), f"{tag}: split-swarm frame {i} differs between the ranks")
        adds = 1000.0 * evaluation.add_s_error(a["pose"], sc.pose_gt, sc.dense)
        check(adds < 5.0, f"{tag}: split-swarm frame {i} ADD-S {adds:.3f} mm >= 5 mm")
        print(f"{tag}: split-swarm frame {i}: ADD-S {adds:.3f} mm, fitness "
              f"{float(a['fitness']):.4f}, bitwise equal on both ranks", flush=True)
    for r, out in got.items():
        for i, (a, ref) in enumerate(zip(out["sweep"]["results"], lb["steps"])):
            check(same(a, arrays(ref)),
                  f"{tag}: rank {r}'s object-sharded step {i} differs from phase 10's")
    a, b = r0["sweep_2d"]["results"][0], r1["sweep_2d"]["results"][0]
    check(same(a, b) and np.isfinite(a["poses"]).all(),
          f"{tag}: the (1, 2) mesh's step is not finite or differs between ranks")
    lib = lb["lib"]
    adds = [1000.0 * evaluation.add_s_error(a["poses"][o], sc.pose_gt, lib.dense[o])
            for o in range(LIB)]
    check(max(adds) < 5.0, f"{tag}: the (1, 2) mesh's ADD-S {adds} >= 5 mm")
    total = {"K1": 0, "K2": 0, "K3": 0}
    for r, out in got.items():
        for case in ("frame", "sweep", "sweep_2d"):
            seen = out[case]["launches"]
            check(bool(seen["K1"]), f"{tag}: rank {r}'s {case} never launched K1")
            check_shapes(knn_cuda, f"{tag} rank {r} {case} path", seen)
            total = add_launches(total, {k: sum(v.values()) for k, v in seen.items()})
    ms = {c: r0[c]["ms"] for c in ("frame", "sweep", "sweep_2d")}
    beside = (f" (phase 4: {single['frame_ms']:.2f} ms/frame, whole swarm)"
              if single else "")
    print(f"{tag}: rank 0's split-swarm frames {[round(t, 2) for t in ms['frame']]} ms"
          f"{beside}; object-sharded init and track steps "
          f"{[round(t, 2) for t in ms['sweep']]} ms, bitwise phase 10's (phase 10: "
          f"{lb['step_ms']:.2f} ms/step); (1, 2) step {ms['sweep_2d'][0]:.2f} ms, "
          f"ADD-S mm {[round(x, 3) for x in adds]}; launches on both ranks {total}",
          flush=True)
    return total


def mesh_phase(sc: Scene, lb: dict, knn_cuda, dev, single: dict | None) -> dict:
    """Phase 14: (a), (b), and (c) where there are two cards; returns each
    kernel's launches in all three."""
    import torch

    n = add_launches(
        run_phase("14a mesh of one", mesh_local_phase, sc, lb, knn_cuda, dev, single),
        run_phase("14b two ranks on one card", mesh_ranks_phase, sc, lb, knn_cuda,
                  single, "gloo"))
    if torch.cuda.device_count() >= 2:
        n = add_launches(n, run_phase("14c a card a rank", mesh_ranks_phase, sc, lb,
                                      knn_cuda, single, "nccl"))
    else:
        print(f"phase 14 (c) not run: {torch.cuda.device_count()} CUDA device "
              f"here, and NCCL needs a card per rank", flush=True)
    return n


def bench_line(knn_cuda, name: str, fn) -> dict:
    """fn() in-process with its standard output captured: exactly one JSON
    line with the keys BENCH_KEYS[name] names, every number in it finite and
    > 0, K1 launched and every launch at a checked shape. Prints the line
    and returns it, parsed."""
    import contextlib
    import io
    import math

    out = io.StringIO()
    reset_counts(knn_cuda)
    with contextlib.redirect_stdout(out):
        fn()
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    check(len(lines) == 1, f"bench {name} printed {len(lines)} lines: {lines}")
    print(f"bench {name}: {lines[0]}", flush=True)
    rec = json.loads(lines[0])
    check(isinstance(rec, dict) and set(rec) == BENCH_KEYS[name],
          f"bench {name} keys {sorted(rec)}")
    bad = {k: v for k, v in rec.items() if isinstance(v, (int, float))
           and not (math.isfinite(v) and v > 0)}
    check(not bad and all(v is not None for v in rec.values()),
          f"bench {name}: a number not finite and > 0, or missing: {rec}")
    check(counts(knn_cuda)["K1"] > 0, f"bench {name} never launched K1")
    check_shapes(knn_cuda, f"bench {name}")
    return rec


def bench_phase(knn_cuda, dev, single: dict | None) -> None:
    """Phase 13: the benchmark's headline and its default library sweep, as
    `bench_torch.py` runs them, beside the same run's phase 4 frame."""
    from icra20_hand_object_pose_tpu_torch import benchmarks

    head = bench_line(knn_cuda, "main", lambda: benchmarks.main(device=dev))
    sweep = bench_line(knn_cuda, "bench_sweep",
                       lambda: benchmarks.bench_sweep(device=dev))
    beside = (f"; phase 4's Tracker.step {single['frame_ms']:.2f} ms/frame, "
              f"profiled {single['device_ms']:.3f} ms device, "
              f"{single['aten_calls']} ATen calls" if single else "")
    print(f"bench: frame program {head['ms_per_frame']} ms/frame, "
          f"Tracker.step {head['e2e_tracker_ms_per_frame']} ms/frame, "
          f"{head['value']} hypotheses/s, profiled frame "
          f"{head['device_ms_per_frame']} ms device, idle {head['idle_share']}, "
          f"{head['aten_calls_per_frame']} ATen calls{beside}; library 8 x 128: "
          f"{sweep['ms_per_object_frame']} ms per object-frame", flush=True)


def blind_init_case(lib, sc: Scene, knn_cuda) -> dict:
    """Phase 15, case 1: a sweep init through K2 (nn_fn) and one under
    fused_gn (K3), each from init_state(): the init step, then one tracked
    step. Returns the launches."""
    import dataclasses

    fused = dataclasses.replace(sc.cfg, icp=dataclasses.replace(sc.cfg.icp, fused_gn=True))
    thr = sc.cfg.tracker.fitness_reinit_threshold
    total = {"K1": 0, "K2": 0, "K3": 0}
    for kernel, sweep in (("K2", lib.sweep(nn_fn=knn_cuda.make_nn_fn())),
                          ("K3", lib.sweep(cfg=fused))):
        reset_counts(knn_cuda)
        st, res0, _, a0, _ = lib.step(sweep, sweep.init_state(),
                                      f"{kernel} sweep init step")
        check(all(res0.reinitialized.tolist()), f"{kernel} sweep step 0 did not "
              f"re-initialize every object: {res0.reinitialized.tolist()}")
        _, res1, _, a1, _ = lib.step(sweep, st, f"{kernel} sweep step 1")
        healthy = [f >= thr for f in res0.fitness.tolist()]
        check(not any(r and h for r, h in zip(res1.reinitialized.tolist(), healthy)),
              f"{kernel} sweep step 1 re-initialized a healthy object")
        for o in range(lib.n):
            check(a0[o] < lib.limits[o] or a1[o] < lib.limits[o],
                  f"{kernel} sweep init missed object {o} ({lib.shapes[o]}): ADD-S "
                  f"{a0[o]:.3f} / {a1[o]:.3f} mm, limit {lib.limits[o]:.3f} mm")
        n, seen = counts(knn_cuda), launched(knn_cuda)
        if kernel == "K2":
            check(n["K2"] > 0 and n["K1"] == 0, f"K2 sweep init launches {n}")
        init_scan = (lib.n * sc.cfg.tracker.reinit_particles, lib.n, 512, 512)
        check(seen[kernel].get(init_scan, 0) > 0,
              f"{kernel} never launched at the sweep init's scan {init_scan}: {seen}")
        check_grouped(knn_cuda, kernel, f"{kernel} sweep init path", lib.n)
        check_shapes(knn_cuda, f"{kernel} sweep init path")
        total = add_launches(total, n)
    return total


def blind_mixed_case(lb: dict, knn_cuda) -> dict:
    """Phase 15, case 2: phase 10's tracked state with the fitness of
    objects 1 and 5 forced to 0: exactly those re-initialize, their results
    bitwise an all-init program's from the same state and seeds, the
    others' an all-track program's; the next state's bookkeeping as
    `LibrarySweep._finish` promises. Returns the launches."""
    import torch

    lib, st = lb["lib"], lb["state"]
    forced = [o in (1, 5) for o in range(lib.n)]
    sweep = lib.sweep()
    st = st._replace(fitness=torch.where(
        torch.tensor(forced, device=lib.dev), torch.zeros_like(st.fitness), st.fitness))
    key, keys_t, keys_i, prev_t, prev_i, need = sweep._prep(st)
    reset_counts(knn_cuda)
    nxt, res, _, adds, _ = lib.step(sweep, st, "mixed step")
    n = counts(knn_cuda)
    check(res.reinitialized.tolist() == forced,
          f"mixed step re-initialized {res.reinitialized.tolist()}, not {forced}")
    args = (lib.depths, lib.hand_bases, lib.hand_qs)
    out_i = sweep._run(keys_i, args[0], prev_i, *args[1:], "init")
    out_t = sweep._run(keys_t, args[0], prev_t, *args[1:], "track")
    for o in range(lib.n):
        ref = out_i if forced[o] else out_t
        check(all(torch.equal(a[o], b[o]) for a, b in (
            (res.poses, ref.pose), (res.fitness, ref.fitness),
            (res.coverage, ref.coverage))),
            f"mixed step object {o} differs from the all-{'init' if forced[o] else 'track'} "
            f"program's")
    tracked = ~need
    check(nxt.key == key and nxt.frame_idx == st.frame_idx + 1
          and bool(nxt.initialized.all()) and torch.equal(nxt.prev_poses, st.poses)
          and torch.equal(nxt.pose_tracked, tracked)
          and torch.equal(nxt.vel_ok, tracked & st.pose_tracked)
          and torch.equal(nxt.poses, res.poses) and torch.equal(nxt.fitness, res.fitness),
          "the mixed step's next state breaks LibrarySweep._finish's bookkeeping")
    print(f"mixed step: objects 1 and 5 bitwise the all-init program's, the rest "
          f"the all-track program's; vel_ok {nxt.vel_ok.tolist()}; launches {n}",
          flush=True)
    return n


def blind_single_case(lib, sc: Scene, knn_cuda, variants) -> dict:
    """Phase 15, case 3: one tracked step's program from the ground truth
    (`_prep` then `_run`, as `step` runs it) per configuration in
    `variants`; object 0 and the last bitwise their single estimates.
    Returns the launches of the sweep programs and the single estimates."""
    import torch

    from icra20_hand_object_pose_tpu_torch import evaluation
    from icra20_hand_object_pose_tpu_torch.models import Estimator

    total = {"K1": 0, "K2": 0, "K3": 0}
    for name, cfg, kw in variants:
        sweep = lib.sweep(cfg=cfg, **kw)
        _, keys_t, _, prev_t, _, _ = sweep._prep(lib.seeded(sweep))
        reset_counts(knn_cuda)
        out, ms, _ = timed_call(lambda: sweep._run(
            keys_t, lib.depths, prev_t, lib.hand_bases, lib.hand_qs, "track"), lib.dev)
        adds = [1000.0 * evaluation.add_s_error(out.pose[o].cpu().numpy(), sc.pose_gt,
                                                lib.dense[o]) for o in range(lib.n)]
        check(max(adds) < 5.0, f"O = {lib.n} {name}: ADD-S {adds} >= 5 mm")
        check_grouped(knn_cuda, {"nn_fn": "K2", "fused_gn": "K3"}.get(name, "K1"),
                      f"O = {lib.n} {name} path", lib.n)
        for o in (0, lib.n - 1):
            single = Estimator(lib.objs[o], sc.hand, cfg, **kw).estimate(
                lib.depths[o], prev_t[o], lib.hand_bases[o], lib.hand_qs[o],
                key=keys_t[o], mode="track")
            for field, a, b in zip(out._fields, out, single):
                check((a is None) == (b is None) and (a is None or torch.equal(a[o], b)),
                      f"O = {lib.n} {name}: object {o}'s {field} differs from its "
                      f"single estimate")
        print(f"O = {lib.n} {name}: tracked step {ms:.2f} ms, ADD-S mm max "
              f"{max(adds):.3f}; objects 0 and {lib.n - 1} bitwise their single "
              f"estimates (every result field)", flush=True)
        check_shapes(knn_cuda, f"O = {lib.n} {name} path")
        total = add_launches(total, counts(knn_cuda))
    return total


def blind_pixel_case(lib, sc: Scene, knn_cuda) -> dict:
    """Phase 15, case 4: the library of `lib` in pixel mode, 2 tracked
    steps from the ground truth: under 5 mm, no re-init, object 0 of the
    first step bitwise its single estimate; peak device memory."""
    import dataclasses

    import torch

    from icra20_hand_object_pose_tpu_torch.models import Estimator

    cfg = dataclasses.replace(sc.cfg, score=dataclasses.replace(sc.cfg.score, mode="pixel"))
    sweep = lib.sweep(cfg=cfg)
    st = lib.seeded(sweep)
    _, keys_t, _, prev_t, _, _ = sweep._prep(st)
    reset_counts(knn_cuda)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(2):
        st, res, t, adds, _ = lib.step(sweep, st, f"O = {lib.n} pixel-mode step {i}")
        ms.append(t)
        check(not any(res.reinitialized.tolist()) and max(adds) < 5.0,
              f"O = {lib.n} pixel-mode step {i}: reinit {res.reinitialized.tolist()}, "
              f"ADD-S {adds}")
        if i == 0:
            first = res
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    single = Estimator(lib.objs[0], sc.hand, cfg).estimate(
        lib.depths[0], prev_t[0], lib.hand_bases[0], lib.hand_qs[0], key=keys_t[0],
        mode="track")
    check(torch.equal(first.poses[0], single.pose) and torch.equal(first.fitness[0], single.fitness)
          and torch.equal(first.coverage[0], single.coverage),
          f"O = {lib.n} pixel mode: object 0 differs from its single estimate")
    n = counts(knn_cuda)
    print(f"O = {lib.n} pixel mode: {ms[0]:.2f}, {ms[1]:.2f} ms/step; object 0 of "
          f"step 0 bitwise its single estimate (pose, fitness, coverage); peak "
          f"device memory {peak:.2f} GiB; launches {n}", flush=True)
    check_shapes(knn_cuda, f"O = {lib.n} pixel-mode path")
    return n


def prior_branch(sweep, st) -> str:
    """Which tracked-mode prior `LibrarySweep._prep` builds from `st`,
    checked against the prior it returns: the pose, the pose tiled over
    the hypothesis slots, the slots themselves, or the constant-velocity
    pair (predicted, pose)."""
    import torch

    tr = sweep.cfg.tracker
    prev_t = sweep._prep(st)[3]
    if tr.n_hypotheses > 1 and st.hyp_poses is not None:
        want = torch.where(torch.isfinite(st.hyp_fitness)[..., None, None],
                           st.hyp_poses, st.poses[:, None])
        name = "hypothesis slots"
    elif tr.n_hypotheses > 1:
        want, name = st.poses[:, None].repeat(1, tr.n_hypotheses, 1, 1), "pose tiled"
    elif tr.motion_prior > 0.0:
        check(prev_t.shape[1] == 2 and torch.equal(prev_t[:, 1], st.poses),
              "the motion prior's second slot is not the pose")
        moved = (prev_t[:, 0] != st.poses).flatten(1).any(1)
        check(torch.equal(moved & ~st.vel_ok, torch.zeros_like(moved)),
              "the motion prior moved an object without a velocity")
        return (f"constant velocity (vel_ok {st.vel_ok.tolist()}, predicted pose "
                f"moved for {moved.sum().item()} objects)")
    else:
        want, name = st.poses, "pose"
    check(torch.equal(prev_t, want), f"the {name} prior is not what _prep built")
    return name


def blind_motion_case(lib, sc: Scene, knn_cuda, dev) -> dict:
    """Phase 15, case 5: each object its own moving sequence
    (generate_sequence on the card, SyntheticSequenceConfig's defaults, seed
    o, 4 frames), 4 steps from init_state(); then from the state after step
    1, frames 2-3 under TrackerConfig(motion_prior=1.0) and under
    n_hypotheses=2, each step's prior branch printed."""
    import dataclasses

    import numpy as np

    from icra20_hand_object_pose_tpu_torch.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )

    seqs = [generate_sequence(m, sc.hand, SyntheticSequenceConfig(
        n_frames=4, camera=sc.cam, seed=o), device=dev) for o, m in enumerate(lib.meshes)]
    frames = [[s[i] for s in seqs] for i in range(4)]
    sweep = lib.sweep()
    st = sweep.init_state()
    reset_counts(knn_cuda)
    adds = []
    for i in range(4):
        st, res, _, a, _ = lib.step(sweep, st, f"motion step {i}", frames=frames[i])
        adds.append(a)
        check(res.reinitialized.tolist() == [i == 0] * lib.n,
              f"motion step {i}: reinitialized {res.reinitialized.tolist()}")
        if i == 1:
            after1 = st
    for o in range(lib.n):
        check(adds[0][o] < lib.limits[o] or adds[1][o] < lib.limits[o],
              f"motion init missed object {o}: ADD-S {adds[0][o]:.3f} / {adds[1][o]:.3f} mm")
        check(max(adds[2][o], adds[3][o]) < 5.0,
              f"motion object {o}: steps 2-3 ADD-S {adds[2][o]:.3f}, {adds[3][o]:.3f} mm")
    for label, tracker_kw in (("motion_prior=1.0", dict(motion_prior=1.0)),
                              ("n_hypotheses=2", dict(n_hypotheses=2))):
        cfg = dataclasses.replace(sc.cfg, tracker=dataclasses.replace(
            sc.cfg.tracker, **tracker_kw))
        sweep, st = lib.sweep(cfg=cfg), after1
        for i in (2, 3):
            branch = prior_branch(sweep, st)
            st, res, _, a, _ = lib.step(sweep, st, f"{label} step on frame {i}",
                                        frames=frames[i])
            check(not any(res.reinitialized.tolist()) and max(a) < 5.0
                  and bool(np.isfinite(res.fitness.cpu().numpy()).all()),
                  f"{label} step on frame {i}: reinit {res.reinitialized.tolist()}, "
                  f"ADD-S {a}")
            print(f"{label} step on frame {i}: _prep's prior branch: {branch}",
                  flush=True)
    n = counts(knn_cuda)
    check_shapes(knn_cuda, "motion path")
    print(f"motion: launches {n}", flush=True)
    return n


def blind_phase(lb: dict, sc: Scene, knn_cuda, dev) -> dict:
    """Phase 15: the sweep paths no other phase runs on the card (module
    docstring). Returns each kernel's launches over the phase."""
    import dataclasses

    lib8 = lb["lib"]
    fused = dataclasses.replace(sc.cfg, icp=dataclasses.replace(sc.cfg.icp, fused_gn=True))
    variants = [("default", sc.cfg, {}), ("nn_fn", sc.cfg, dict(nn_fn=knn_cuda.make_nn_fn())),
                ("fused_gn", fused, {})]
    total = blind_init_case(lib8, sc, knn_cuda)
    total = add_launches(total, blind_mixed_case(lb, knn_cuda))
    lib2 = Library(sc, dev, LIB_MESHES, n=2)
    for lib in (lib8, lib2, Library(sc, dev, LIB_MESHES, n=32)):
        total = add_launches(total, blind_single_case(lib, sc, knn_cuda, variants))
    total = add_launches(total, blind_pixel_case(lib2, sc, knn_cuda))
    total = add_launches(total, blind_motion_case(lib8, sc, knn_cuda, dev))
    print(f"blind paths: launches {total}", flush=True)
    return total


def _script(name: str):
    """scripts/<name>.py of this checkout, loaded as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                        f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def scripts_phase(knn_cuda) -> None:
    """Phase 16: scripts/calibrate_base_agree_torch.py at --trials 2 and
    scripts/ab_scan_icp_torch.py at --frames 2 --seeds 1 --only base, each
    in-process on the card with its standard output captured: the
    reference's JSON keys, every number finite, each within 60 s."""
    import contextlib
    import io
    import math

    runs = (("calibrate_base_agree_torch", ["--trials", "2"]),
            ("ab_scan_icp_torch", ["--frames", "2", "--seeds", "1", "--only", "base"]))
    for name, argv in runs:
        mod, out = _script(name), io.StringIO()
        reset_counts(knn_cuda)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            mod.main(argv)
        secs = time.perf_counter() - t0
        text = out.getvalue()
        print(f"{name} {' '.join(argv)} ({secs:.1f} s): {text.strip()}", flush=True)
        check(secs < 60.0, f"{name} took {secs:.1f} s, not under 60 s")
        if name.startswith("calibrate"):
            rec = json.loads(text)
            check(set(rec) == {"calibrated", "miscalibrated"} and all(
                set(r) == CALIBRATE_KEYS and len(r["gains"]) == 2 for r in rec.values()),
                f"{name} printed {sorted(rec)}")
            numbers = [v for r in rec.values() for k, v in r.items() if k != "gains"]
            numbers += [g for r in rec.values() for g in r["gains"]]
        else:
            lines = text.strip().splitlines()
            check(len(lines) == 1, f"{name} printed {len(lines)} lines")
            rec = json.loads(lines[0])
            check(set(rec) == AB_SCAN_KEYS and rec["n_err"] == 2, f"{name} printed {rec}")
            numbers = [v for v in rec.values() if isinstance(v, (int, float))]
            check(counts(knn_cuda)["K1"] > 0, f"{name} never launched K1")
            check_shapes(knn_cuda, f"{name} path")
        check(all(math.isfinite(v) for v in numbers), f"{name}: a number is not finite")


def _tests_module(name: str):
    """tests/<name>.py of this checkout (a module that imports no jax)."""
    tests = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import importlib

    return importlib.import_module(name)


def _reference_json(name: str) -> dict:
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                           name)) as f:
        return json.load(f)


def pose_stream_case(sq: dict, dev, rule: dict) -> dict:
    """Phase 17 (b): phase 7's sequence tracked from a cold start with the
    demo's estimator, against the JAX package's streams 0 and 1 of it."""
    import numpy as np

    from icra20_hand_object_pose_tpu_torch import evaluation, parity
    from icra20_hand_object_pose_tpu_torch.models import Tracker

    ref = _reference_json("torch_ref_pose_stream.json")
    check({k: ref["sequence"][k] for k in DEMO} == DEMO,
          f"the reference streams are of {ref['sequence']}, not phase 7's {DEMO}")
    seq, dense = sq["seq"], sq["dense"]
    tracker = Tracker(_demo_estimator(sq, dev))
    port = [tracker.step(fr.depth, fr.hand_base, fr.hand_q).pose.cpu().numpy()
            for fr in seq]
    check(all(np.isfinite(p).all() for p in port), "phase 17 stream: a pose is not finite")
    ref0, ref1 = ([np.asarray(p, np.float64) for p in ref["streams"][k]] for k in "01")
    d = {name: 1000.0 * parity.compare_pose_sequences(a, ref0, dense).add_s_mean
         for name, a in (("port", port), ("ref1", ref1))}
    limit = rule["k"] * d["ref1"] + rule["m_mm"]
    gt = [seq[i].pose_gt for i in range(len(seq))]
    adds = {name: 1000.0 * float(np.mean([evaluation.add_s_error(p, g, dense)
                                          for p, g in zip(s, gt)]))
            for name, s in (("port", port), ("ref0", ref0), ("ref1", ref1))}
    print(f"17b pose stream (phase 7's sequence, VGA, 512 particles, cold start): "
          f"d(port, ref0) {d['port']:.3f} mm, d(ref1, ref0) {d['ref1']:.3f} mm, "
          f"limit k d(ref1, ref0) + m = {rule['k']} x {d['ref1']:.3f} + "
          f"{rule['m_mm']:.3f} = {limit:.3f} mm; BASELINE's reading (not a gate): "
          f"mean ADD-S against the ground truth port {adds['port']:.3f}, ref0 "
          f"{adds['ref0']:.3f}, ref1 {adds['ref1']:.3f} mm (port - ref0 "
          f"{adds['port'] - adds['ref0']:+.3f} mm)", flush=True)
    check(d["port"] <= limit, f"the port's stream is {d['port']:.3f} mm from the "
          f"reference's, beyond k d(ref1, ref0) + m = {limit:.3f} mm")
    return dict(d_port_ref0_mm=d["port"], d_ref1_ref0_mm=d["ref1"], limit_mm=limit,
                adds_mm=adds)


def _summary(stat_of, op: str, values: list) -> tuple:
    """(median, worst) of a statistic: worst is the largest for a `<`
    assertion, else the smallest."""
    import numpy as np

    vals = [stat_of(v) for v in values]
    return float(np.median(vals)), float(max(vals) if op == "<" else min(vals))


def gates_phase(sq: dict, knn_cuda, dev) -> dict:
    """Phase 17 (module docstring): every case of the reference's accuracy
    gates at S_card seeds, judged by pass rate against the reference's
    rate over its seeds, and phase 7's pose stream against the reference's.
    Returns each kernel's launches over the phase."""
    import math

    from scipy.stats import fisher_exact

    t0 = time.perf_counter()
    G = _tests_module("torch_gate_cases")
    table = _reference_json("torch_gate_reference.json")
    check(set(table["cases"]) == set(G.CASES),
          "tests/torch_gate_reference.json does not hold every case")
    backend = G.PortBackend(dev)
    reset_counts(knn_cuda)
    stream = pose_stream_case(sq, dev, table["pose_stream"])
    runs = {c: [] for c in G.CASES}
    seed_s = []
    while len(seed_s) < GATE_MAX_SEEDS:
        s = len(seed_s)
        ts = time.perf_counter()
        for case in G.CASES:
            r = G.run(case, s, backend=backend)
            check(all(math.isfinite(v) for v in r.stats.values() if isinstance(v, float)),
                  f"{case} seed {s}: a statistic is not finite: {r.stats}")
            runs[case].append(r)
        seed_s.append(time.perf_counter() - ts)
        spent = time.perf_counter() - t0
        print(f"17 gates: seed {s} in {seed_s[-1]:.1f} s ({spent:.1f} s of the phase)",
              flush=True)
        if (len(seed_s) >= GATE_MIN_SEEDS
                and spent + GATE_SEED_MARGIN * max(seed_s) > GATE_BUDGET_S):
            break
    S = len(seed_s)
    rows, lost = {}, []
    for case, rs in runs.items():
        ref = table["cases"][case]
        stat, op, _ = ref["checks"][0]
        port_med, port_worst = _summary(lambda r: r.stats[stat], op, rs)
        ref_med, ref_worst = _summary(lambda p: p["stats"][stat], op, ref["per_seed"])
        passes = sum(r.passed for r in rs)
        rows[case] = dict(passes=passes, seeds=S, stat=stat, median=port_med,
                          worst=port_worst, values=[r.stats[stat] for r in rs],
                          ref_passes=ref["passes"], ref_seeds=ref["seeds"],
                          ref_median=ref_med, ref_worst=ref_worst)
        if ref["passes"] == ref["seeds"] and 2 * (S - passes) > S:
            lost.append(case)
        print(f"17 {case}: port {passes}/{S} ({stat} median {port_med:.3f}, worst "
              f"{port_worst:.3f}) | reference {ref['passes']}/{ref['seeds']} (median "
              f"{ref_med:.3f}, worst {ref_worst:.3f})", flush=True)
        for r in rs:
            if not r.passed:
                print(f"    failed: {r.message()}", flush=True)
    a = sum(r["passes"] for r in rows.values())
    n1 = S * len(rows)
    b = sum(r["ref_passes"] for r in rows.values())
    n2 = sum(r["ref_seeds"] for r in rows.values())
    _, p = fisher_exact([[a, n1 - a], [b, n2 - b]], alternative="less")
    n = counts(knn_cuda)
    secs = time.perf_counter() - t0
    print(f"17 gates: S_card {S} seeds a case; pooled pass rate port {a}/{n1} = "
          f"{a / n1:.4f}, reference {b}/{n2} = {b / n2:.4f}; one-sided Fisher exact "
          f"p = {p:.4g} (fails below {GATE_P}); cases the reference passes on every "
          f"seed and the port fails on most: {lost or 'none'}; launches {n}; "
          f"{secs:.1f} s of the {GATE_BUDGET_S:.0f} s budget", flush=True)
    check_shapes(knn_cuda, "gates path")
    print(json.dumps({"gates": dict(
        seeds=S, pooled=dict(port=[a, n1], reference=[b, n2], fisher_p=p),
        lost_cases=lost, cases=rows, pose_stream=stream, seconds=secs)}), flush=True)
    check(n["K1"] > 0, "the gates never launched K1")
    check(p >= GATE_P, f"the port's pooled pass rate {a}/{n1} is below the "
          f"reference's {b}/{n2} (one-sided Fisher p = {p:.4g} < {GATE_P})")
    check(not lost, f"cases the reference passes on every seed fail on most of "
          f"the card's: {lost}")
    check(secs <= GATE_BUDGET_S, f"phase 17 took {secs:.1f} s, over its "
          f"{GATE_BUDGET_S:.0f} s budget")
    return n


def profile_phases(dev) -> None:
    """scripts/profile_phases_torch.py's main on the card."""
    _script("profile_phases_torch").main(device=dev)


def run_phase(name: str, fn, *args):
    """fn(*args), with the phase's seconds printed."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one",
              file=sys.stderr)
        return 1
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _, log = knn_cuda.build()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in log.splitlines():
        if line.startswith("==") or any(k in line for k in (
                "Compiling entry", "registers", "spill")):
            print("  ptxas:", line.strip(), flush=True)

    if "--sweep" in argv:
        sweep_phase(knn_cuda, dev)
        print(smi, flush=True)
        return 0
    grouped = "--ungrouped" not in argv
    stats = {"K1": run_phase("3 K1", nn_phase, knn_cuda, dev, True, grouped),
             "K2": run_phase("3 K2", nn_phase, knn_cuda, dev, False, grouped),
             "K3": run_phase("3 K3", k3_phase, knn_cuda, dev, grouped)}
    if "--kernels-only" in argv:
        print(smi, flush=True)
        return 0
    if "--bench-only" in argv:
        run_phase("13 bench", bench_phase, knn_cuda, dev, None)
        run_phase("profile_phases_torch", profile_phases, dev)
        print(smi, flush=True)
        return 0
    sc = Scene(dev)
    if "--library-only" in argv:
        with tempfile.TemporaryDirectory() as work:
            lb = run_phase("10 library", library_phase, sc, knn_cuda, dev, None)
            run_phase("11 shared scene", shared_phase, sc, knn_cuda, dev)
            run_phase("12 library kernels", library_kernels_phase, lb, sc, knn_cuda,
                      dev, work)
        run_phase("14 mesh", mesh_phase, sc, lb, knn_cuda, dev, None)
        run_phase("15 blind paths", blind_phase, lb, sc, knn_cuda, dev)
        print(smi, flush=True)
        return 0
    k1, single = run_phase("4 track", track_phase, sc, knn_cuda)
    launches = {"K1": k1,
                "K3": run_phase("5 cold start", cold_start_phase, sc, knn_cuda),
                "K2": run_phase("6 nn_fn", nn_fn_phase, sc, knn_cuda)}
    with tempfile.TemporaryDirectory() as work:
        sq = run_phase("7 sequence", sequence_phase, knn_cuda, dev, work)
        run_phase("8 checkpoint", checkpoint_phase, sq, knn_cuda, dev, work)
        run_phase("9 pixel mode", pixel_phase, sq, knn_cuda, dev)
        lb = run_phase("10 library", library_phase, sc, knn_cuda, dev, single)
        run_phase("11 shared scene", shared_phase, sc, knn_cuda, dev)
        lib_launches = dict(run_phase("12 library kernels", library_kernels_phase,
                                      lb, sc, knn_cuda, dev, work),
                            K1=lb["launches"])
        run_phase("13 bench", bench_phase, knn_cuda, dev, single)
        mesh_launches = run_phase("14 mesh", mesh_phase, sc, lb, knn_cuda, dev, single)
        blind_launches = run_phase("15 blind paths", blind_phase, lb, sc, knn_cuda, dev)
        run_phase("16 scripts", scripts_phase, knn_cuda)
        gate_launches = run_phase("17 accuracy gates", gates_phase, sq, knn_cuda, dev)

    names = {"K1": "nn_gather_batched", "K2": "nn_batched", "K3": "nn_gn_batched"}
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": names[k], "route": "cuda", "source": SOURCE[k],
        "replaces": REPLACES[k], "launches": launches[k],
        "library_sweep_launches": lib_launches[k],
        "mesh_launches": mesh_launches[k],
        "blind_path_launches": blind_launches[k],
        "gate_launches": gate_launches[k],
        **stats[k], "library_ms": None,
    } for k in ("K1", "K2", "K3")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
