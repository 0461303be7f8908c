"""The CUDA kernels' launch plans and build cache, which stay in Python and
run without a card.

- Every shape that chip_smoke.py times on the main path (NN_SHAPES for K1
  and K2, GN_SHAPES for K3) gets a plan that covers all of Ns and Nm, with
  at most MAX_GROUPS thread groups and at most MAX_SCENE_SPLIT blocks per
  particle, and follows the plan rule of ops/knn_cuda.py.
- The library's name hashes the nvcc flags and every `*.cu` and `*.cuh`
  in csrc/: editing the shared search header rebuilds.
- `knn_cuda.KERNELS` declares each C entry point as its prototype in
  csrc/ does; a launch is counted once per replay of the capture that
  recorded it, and `launch_counts()` keeps the form the benchmark diffs.
"""
import collections
import re
import shutil

import pytest

import chip_smoke
from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
from icra20_hand_object_pose_tpu_torch.utils import profiling

def _check_covers(plan, Ns, Nm):
    assert plan.q in (1, 2, 4)
    assert plan.width in (knn_cuda.SMALL_WIDTH, knn_cuda.WIDTH)
    assert 1 <= plan.groups <= knn_cuda.MAX_GROUPS
    assert 1 <= plan.scene_split <= knn_cuda.MAX_SCENE_SPLIT
    # the query (scene) tiles cover Ns, and no block of a split is idle
    tiles = knn_cuda._tiles(Ns, plan.q, plan.width)
    assert tiles * plan.q * plan.width >= Ns > (tiles - 1) * plan.q * plan.width
    assert plan.scene_split <= tiles
    # the groups' contiguous ranges of ceil(Nm / groups) cover Nm
    per = -(-Nm // plan.groups)
    assert plan.groups * per >= Nm and per >= 1


@pytest.mark.parametrize("P,Ns,Nm", chip_smoke.NN_SHAPES)
def test_nn_plan_covers_main_path_shapes(P, Ns, Nm):
    plan = knn_cuda.nn_plan(P, Ns, Nm)
    _check_covers(plan, Ns, Nm)
    assert plan.scene_split == 1
    if plan.q == 4:         # one block per tile of 4 x 128 queries fills the card
        assert P * knn_cuda._tiles(Ns, 4) >= 2 * knn_cuda.SMS
    else:                   # else narrow tiles, the reference split over groups
        assert plan.width == knn_cuda.SMALL_WIDTH
        assert -(-Nm // plan.groups) >= min(Nm, knn_cuda.MIN_RANGE)


@pytest.mark.parametrize("P,Ns,Nm", chip_smoke.GN_SHAPES)
def test_gn_plan_covers_main_path_shapes(P, Ns, Nm):
    plan = knn_cuda.gn_plan(P, Ns, Nm)
    _check_covers(plan, Ns, Nm)
    assert plan.width == knn_cuda.WIDTH
    if plan.q == 4:         # one block per particle where particles fill the card
        assert plan.scene_split == 1 and P >= 2 * knn_cuda.SMS
    else:                   # else the scene splits until the card fills or runs out
        full = P * plan.scene_split >= 2 * knn_cuda.SMS
        limit = min(knn_cuda.MAX_SCENE_SPLIT, knn_cuda._tiles(Ns, 1))
        assert full or plan.scene_split == limit


@pytest.mark.parametrize("P,Ns,Nm", [(1, 1, 1), (7, 4096, 5000), (65535, 33, 9)])
def test_plans_cover_edge_shapes(P, Ns, Nm):
    _check_covers(knn_cuda.nn_plan(P, Ns, Nm), Ns, Nm)
    _check_covers(knn_cuda.gn_plan(P, Ns, Nm), Ns, Nm)


def test_main_path_plans():
    """The plans the device-time sweeps chose at the main-path shapes: the
    in-scan and the tracked and init scans fill the card with one block per
    tile of 4 x 128 queries; the explorer and polish searches, too small for
    that, take 64-query tiles and split the reference cloud over 4 thread
    groups; K3's explorer pulls split the scene over 4 blocks."""
    Plan = knn_cuda.Plan
    assert knn_cuda.nn_plan(512, 512, 256) == Plan(4, 1, 1)
    assert knn_cuda.nn_plan(32, 512, 256) == Plan(2, 4, 1, 64)
    assert knn_cuda.nn_plan(18, 2048, 1024) == Plan(1, 4, 1, 64)
    assert knn_cuda.gn_plan(512, 512, 256) == Plan(4, 1, 1)
    assert knn_cuda.gn_plan(32, 512, 256) == Plan(1, 2, 4)
    assert knn_cuda.gn_plan(1024, 512, 512) == Plan(4, 1, 1)


@pytest.mark.parametrize("name,hashed", [("nn_search.cuh", True), ("nn_gather.cu", True),
                                         ("nn_gn.cu", True), ("NOTES.txt", False)])
def test_library_name_hashes_sources_and_headers(tmp_path, name, hashed):
    src = tmp_path / "csrc"
    shutil.copytree(knn_cuda.CSRC, src)
    before = knn_cuda.library_name(src)
    assert before == knn_cuda.library_name(knn_cuda.CSRC)
    with open(src / name, "a") as f:
        f.write("\n// edited\n")
    assert (knn_cuda.library_name(src) != before) == hashed


def test_build_compiles_only_cu_files():
    """The header is hashed but compiled only through the sources that
    include it: the search kernels' (K4, the Gauss-Newton tail, and K5 and
    K6, the scorers, run no search)."""
    assert (knn_cuda.CSRC / "nn_search.cuh").exists()
    assert sorted(p.name for p in knn_cuda.CSRC.glob("*.cu")) == [
        "gn_iterate.cu", "nn_gather.cu", "nn_gn.cu", "project_compare.cu",
        "splat_compare.cu"]
    for name in ("nn_gather.cu", "nn_gn.cu"):
        assert '#include "nn_search.cuh"' in (knn_cuda.CSRC / name).read_text()
    for name in ("gn_iterate.cu", "splat_compare.cu", "project_compare.cu"):
        assert "nn_search.cuh" not in (knn_cuda.CSRC / name).read_text()


@pytest.mark.parametrize("P,G", [(256, 8), (1024, 32), (16384, 32), (36, 2)])
def test_k3_default_plan_follows_one_group(monkeypatch, P, G):
    """K3's default plan sets the order of each particle's sums, so it is
    the plan of one group's P // G particles: a library's grouped launch and
    a group launched alone run the same plan (the wrapper's launch recorded,
    no card needed)."""
    import torch

    plans = []

    def call(kernel, device, values):
        a = _by_name(kernel, values)
        plans.append((a["q"], a["S"], a["scene_split"]))

    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    monkeypatch.setattr(knn_cuda, "_route", lambda *a, **k: True)
    monkeypatch.setattr(knn_cuda, "_call", call)
    Ns, Nm, per = 512, 256, P // G
    z = torch.zeros
    gates = dict(maxd2=4e-4, min_cos=0.5)
    knn_cuda.nn_gn_batched(z(G, Ns, 3), z(G, Ns, 3), z(G, Ns), z(P, Nm, 3), z(P, Nm, 3),
                           **gates)
    knn_cuda.nn_gn_batched(z(Ns, 3), z(Ns, 3), z(Ns), z(per, Nm, 3), z(per, Nm, 3),
                           **gates)
    want = knn_cuda.gn_plan(per, Ns, Nm)
    assert plans == [(want.q, want.groups, want.scene_split)] * 2


def _by_name(kernel, values) -> dict:
    """The values a launch hands the C entry point, by declared name."""
    assert len(values) == len(kernel.args) - 1        # all but the stream
    return dict(zip((name for name, _ in kernel.args), values))


def _all_six(z, torch):
    """One call of each of K1-K6's wrappers at tiny shapes; their shape
    keys by wrapper."""
    knn_cuda.nn_gather_batched(z(1, 8, 3), z(4, 4, 4), z(16, 3), z(16, 3))
    knn_cuda.nn_batched(z(2, 8, 3), z(4, 16, 3))
    knn_cuda.nn_gn_batched(z(8, 3), z(8, 3), z(8), z(4, 16, 3), z(4, 16, 3), maxd2=1e-4,
                           min_cos=0.5)
    knn_cuda.gn_iterate_batched(
        z(2, 3, 4, 4), z(2, 3, dtype=torch.bool), z(2, 3, 8, 3), z(2, 3, 8, 3), z(2, 3, 8),
        z(2, 8, 3), z(1, 8, 3), z(2, 8), z(2, 3), z(2), max_corresp_dist=0.01, min_cos=0.5,
        damping=1e-3, step_scale=1.0, converge_tol=1e-4, gn_reps=2, support_tau=0.005)
    knn_cuda.splat_compare_batched(
        z(5, 7, 3), z(7), z(6, 5), z(6, 5, dtype=torch.bool), z(6, 5), None, fx=1.0, fy=1.0,
        cx=0.0, cy=0.0, height=6, width=5, radius=1, depth_tau=0.01, wrong_side_penalty=2.0,
        occlusion_margin=0.005, invalid_penalty=0.3, ghost_dilate=1)
    knn_cuda.project_compare_batched(
        z(2, 4, 4, 4), z(2, 8, 3), z(2, 8, 3), z(1, 6, 5), z(1, 6, 5, dtype=torch.bool),
        fx=1.0, fy=1.0, cx=0.0, cy=0.0, height=6, width=5, observed_enc=z(1, 6, 5),
        subpixel=True)
    return {"nn_gather_batched": (4, 1, 8, 16), "nn_batched": (4, 2, 8, 16),
            "nn_gn_batched": (4, 1, 8, 16), "gn_iterate_batched": (6, 2, 8),
            "splat_compare_batched": (5, 7, 6, 5),
            "project_compare_batched": (8, 8, 6, 5, "take", True)}


def test_capture_launches_count_once_per_replay(monkeypatch):
    """A CUDA graph's capture records launches without making them: what
    the wrappers counted while it recorded comes back out of the counts
    (`profiling.recording`) and is counted once per replay
    (`profiling.recount`). The CPU program's plain path counts each wrapper
    call as it runs and records nothing to replay (the wrappers' launches
    recorded with no card, as above)."""
    import torch

    from icra20_hand_object_pose_tpu_torch.utils import program

    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    monkeypatch.setattr(knn_cuda, "_route", lambda *a, **k: True)
    monkeypatch.setattr(knn_cuda, "_call", lambda *args: None)
    z = torch.zeros
    k6 = (8, 8, 6, 5, "take", False)                    # K6's (P, N, H, W, rule, subpixel)

    def body(src, query, ref):
        knn_cuda.nn_gather_batched(query, z(4, 4, 4), ref[0], ref[0])
        knn_cuda.nn_gather_batched(query, z(4, 4, 4), ref[0], ref[0])
        knn_cuda.nn_gn_batched(query[0], query[0], z(8), ref, ref, maxd2=1e-4,
                               min_cos=0.5)
        knn_cuda.project_compare_batched(
            z(2, 4, 4, 4), z(2, 8, 3), z(2, 8, 3), z(1, 6, 5), z(1, 6, 5, dtype=torch.bool),
            fx=1.0, fy=1.0, cx=0.0, cy=0.0, height=6, width=5, observed_enc=z(1, 6, 5))
        return (ref,)

    before = knn_cuda.launch_counts()
    with profiling.recording() as rec:
        body(None, z(1, 8, 3), z(4, 16, 3))             # as a capture records
    assert knn_cuda.launch_counts() == before
    assert rec == {("nn_gather_batched", (4, 1, 8, 16)): 2,
                   ("nn_gn_batched", (4, 1, 8, 16)): 1, ("project_compare_batched", k6): 1}
    assert not [k for k in rec if k[0] == "nn_batched"]
    for _ in range(3):                                  # three replays
        profiling.recount(rec)
    counts = knn_cuda.launch_counts()
    assert counts["nn_gather_batched"] == (6, {(4, 1, 8, 16): 6})
    assert counts["nn_gn_batched"][0] == 3 and counts["nn_batched"][0] == 0
    assert counts["project_compare_batched"][1] == {k6: 3}

    prog = program.Program(torch.device("cpu"), 1)
    prog(body, [0], (z(1, 8, 3), z(4, 16, 3)), {})
    counts = knn_cuda.launch_counts()
    assert counts["nn_gather_batched"][0] == 8 and counts["nn_gn_batched"][0] == 4
    assert counts["project_compare_batched"][0] == 4
    assert prog.record == {} and prog.replays == 0


def test_launch_counts_form_through_capture_and_replays(monkeypatch):
    """`launch_counts()` in the form `portbench/trace.py` diffs, through a
    stubbed capture of one call of each kernel and three replays: every
    wrapper's name, each with (launches, Counter of shape tuples), a
    kernel never launched as (0, Counter()); a launch with an argument
    missing or not declared raises and counts nothing."""
    import torch

    monkeypatch.setattr(profiling, "_COUNTS", collections.Counter())
    monkeypatch.setattr(knn_cuda, "_route", lambda *a, **k: True)
    monkeypatch.setattr(knn_cuda, "_call", lambda *args: None)
    names = [k.name for k in knn_cuda.KERNELS]
    before = knn_cuda.launch_counts()
    assert before == {name: (0, collections.Counter()) for name in names}
    with profiling.recording() as rec:
        keys = _all_six(torch.zeros, torch)
    assert knn_cuda.launch_counts() == before
    for _ in range(3):
        profiling.recount(rec)
    after = knn_cuda.launch_counts()
    assert list(after) == names
    for name, (n, shapes) in after.items():
        assert type(n) is int and type(shapes) is collections.Counter
        assert (n, dict(shapes)) == (3, {keys[name]: 3})
    diff = {w: (after[w][0] - before[w][0], after[w][1] - before[w][1]) for w in after}
    assert diff == {name: (3, collections.Counter({keys[name]: 3})) for name in names}
    args = dict(query=None, ref_pts=None, d2=None, idx=None, P=4, Pq=1, Ns=8, Nm=16, q=1,
                width=64)
    with pytest.raises(TypeError, match="missing \\['S'\\]"):
        knn_cuda.launch(knn_cuda.K2, torch.device("cpu"), (4, 1, 8, 16), **args)
    with pytest.raises(TypeError, match="not declared \\['groups'\\]"):
        knn_cuda.launch(knn_cuda.K2, torch.device("cpu"), (4, 1, 8, 16), S=1, groups=1,
                        **args)
    assert knn_cuda.launch_counts() == after


def _prototypes() -> dict:
    """Each `extern "C" int <symbol>(...)` in csrc/*.cu: its parameters as
    (name, type class), the class "ptr", "int", "long long" or "float"."""
    out = {}
    for src in sorted(knn_cuda.CSRC.glob("*.cu")):
        for symbol, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)',
                                         src.read_text()):
            decl = []
            for p in params.split(","):
                words = p.replace("*", " * ").split()
                decl.append((words[-1], "ptr" if "*" in words else " ".join(words[:-1])))
            out[symbol] = decl
    return out


@pytest.mark.parametrize("kernel", knn_cuda.KERNELS, ids=lambda k: k.name)
def test_table_matches_the_c_prototype(kernel):
    """The table declares each kernel's C entry point as `csrc/` does: the
    same number of arguments, the same type class in the same order
    (pointer, int, long long, float), under the prototype's names, the
    stream last: a miscount or a swap fails here, not only on the card."""
    import ctypes

    classes = {ctypes.c_void_p: "ptr", ctypes.c_int: "int", ctypes.c_longlong: "long long",
               ctypes.c_float: "float"}
    proto = _prototypes()[kernel.symbol]
    assert len(kernel.args) == len(proto)
    assert [classes[ty] for _, ty in kernel.args] == [kind for _, kind in proto]
    assert [name for name, _ in kernel.args] == [name for name, _ in proto]
    assert kernel.args[-1] == ("stream", ctypes.c_void_p) and proto[-1] == ("stream", "ptr")
