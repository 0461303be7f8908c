"""The reference's own pass rates on its accuracy gates, and its pose
streams: the measurements the port's gates are judged against. Not a test
(pytest does not collect it); run on the CPU from the repo root:

    JAX_PLATFORMS=cpu python tests/port_gate_parity.py            # all, ~60 min
    JAX_PLATFORMS=cpu python tests/port_gate_parity.py --only gates --jobs 3
    JAX_PLATFORMS=cpu python tests/port_gate_parity.py --only streams
    JAX_PLATFORMS=cpu python tests/port_gate_parity.py --only draws       # ~1 min
    JAX_PLATFORMS=cpu python tests/port_gate_parity.py --only behaviour --jobs 3  # ~7 min
    JAX_PLATFORMS=cpu python tests/port_gate_parity.py --only stages --jobs 4  # ~12 min

`gates`: every case of the six statistical test files
(`tests/torch_gate_cases.CASES`) run with the JAX package over seeds
0 .. S - 1 (S = 8). The scenario code is the case module's, with
`JaxBackend` and `JaxDraws` below plugged in: the seed offsets each case's
`jax.random` keys (`key(97 + seed)`, `split(key(0 + seed), N)`,
`Tracker(est, seed=seed)`), the numpy scene draws stay the reference
test's, and seed 0 is the reference test itself. Writes
`tests/torch_gate_reference.json`: per case its configuration, its checks,
passes / S and every seed's statistics.

`streams`: (1) the self-distance of the JAX Tracker at
`__graft_entry__._tiny_setup`'s sizes on 160 x 120 sequences: for each of
8 sequence seeds, the tracker at keys 0-3 on one sequence, and the mean
ADD-S of keys 1-3's streams against key 0's (`parity.
compare_pose_sequences` on the dense cloud). The rule that
`tests/test_torch_pose_stream.py` applies, d(port, ref0) <= k d(ref1, ref0)
+ m, takes m = 0 and the least k with which keys 2 and 3 pass it on every
sequence seed (stored with the gates). (2) Two JAX pose streams (keys 0 and
1) of `chip_smoke.py` phase 7's sequence (`cli demo` at VGA, 512
particles, 8 frames, the default config), tracked as `cli demo` tracks it:
`tests/torch_ref_pose_stream.json`, which phase 17 compares the port's
stream with.

`draws`: every draw the gate cases take from `jax.random` (`JaxDraws`:
trial orientations, recovery and path perturbations) at seeds 0 .. S - 1,
logged call by call with its arguments and the arrays it returned by
running each case's scenario builder (`torch_gate_cases.draw_calls`, no
rendering, no estimator): `tests/torch_gate_draws.json`, which
`torch_gate_cases.RecordedDraws` serves, so that the card runs the
reference's own scenes without jax.

`behaviour`: `tests/test_hand.py::
test_config_select_recovers_evidence_under_wrong_nominal_q` over seeds
0 .. K - 1 (K = 16), three ways: the reference's body with
`jax.random.key(0)` replaced by `key(k)` (the test file itself unchanged);
the port's runs on its own stream (`test_torch_hand_behaviour.
config_select_run`); and the reference's body with the finger samples the
port drew at each seed injected into its hand, the scenes the port's runs
saw. Beside them each package's evidence rate over 300 seeds of its own
first stage, and the port's seed 0 traced against the reference on the
same samples (scene prep, then the search over 16 seeds):
`tests/torch_behaviour_reference.json`.

`stages`: the port on the CPU (no jax: port output only) through
`torch_gate_cases.staged_occlusion` for the levels and seeds of
`chip_smoke.py` phase 17 (d), every estimator draw from host generators,
and the port's max tracked ADD-S at those levels over seeds 0 .. S - 1 on
the reference's scenes and on the port's: `tests/torch_gate_stages_cpu.json`,
the record the card's run of the same scenes is held against.
"""
import argparse
import json
import os
import platform
import socket
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

# the draws of tests/conftest.py: the reference tests run with it on
jax.config.update("jax_threefry_partitionable", True)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)

import torch_gate_cases as G  # noqa: E402
from chip_smoke import DEMO  # noqa: E402  (phase 7's `cli demo` sizes)

REFERENCE_JSON = os.path.join(HERE, "torch_gate_reference.json")
STREAM_JSON = os.path.join(HERE, "torch_ref_pose_stream.json")
BEHAVIOUR_JSON = os.path.join(HERE, "torch_behaviour_reference.json")
# seeds of the config-selection test's records
BEHAVIOUR_KEYS = 16
# seeds of the config-selection test's evidence rates
RECOVERY_DRAWS = 300
# search seeds of the trace of the port's seed 0, and the distance from the
# object's surface beyond which a scene point counts as off the object
TRACE_SEARCH_SEEDS = 16
OFF_OBJECT_M = 0.003
# seeds per case of the gates
SEEDS = 8
# the tiny pose-stream measurement: sequence seeds, tracker keys, frames
STREAM_SEEDS = 8
STREAM_KEYS = 4
STREAM_FRAMES = 6


class JaxDraws:
    """The reference's draws: jax.random keys split and folded as the
    reference tests do."""

    @staticmethod
    def _key(base, n, t, tag):
        k = jax.random.split(jax.random.key(base), n)[t]
        return k if tag is None else jax.random.fold_in(k, tag)

    def rotation(self, base, n, t, tag):
        from icra20_hand_object_pose_tpu.utils import se3

        return np.asarray(se3.random_rotation(self._key(base, n, t, tag)))

    def perturb(self, base, n, t, tag, pose, rot_sigma, trans_sigma):
        from icra20_hand_object_pose_tpu.utils import se3

        return np.asarray(se3.perturb_pose(
            self._key(base, n, t, tag), jnp.asarray(pose), rot_sigma,
            trans_sigma)).astype(np.float32)

    def path(self, base, pose, n_frames, rot_sigma, trans_sigma):
        from icra20_hand_object_pose_tpu.utils import se3

        key = jax.random.key(base)
        out = [np.asarray(pose, np.float32)]
        for f in range(n_frames):
            key, k1 = jax.random.split(key)
            if f > 0:
                out.append(np.asarray(se3.perturb_pose(
                    k1, jnp.asarray(out[-1]), rot_sigma, trans_sigma)).astype(np.float32))
        return out


class JaxBackend(G.PortBackend):
    """The JAX package behind the case module's backend interface."""

    def __init__(self, device="cpu"):
        from icra20_hand_object_pose_tpu import datasets, evaluation, models
        from icra20_hand_object_pose_tpu.utils import config, meshio, se3

        self.device = device
        self.datasets, self.models, self.config = datasets, models, config
        self.meshio, self._se3, self.evaluation = meshio, se3, evaluation
        self._cache = {}

    def hand(self, **kw):
        return self._cached(("hand", tuple(sorted(kw.items()))),
                            lambda: self.models.make_t42_hand(**kw))

    def object(self, mesh, shape, **kw):
        return self._cached(("obj", shape, tuple(sorted(kw.items()))),
                            lambda: self.models.ObjectModel(mesh, **kw))

    def render_frame(self, *args, **kw):
        return self.datasets.render_frame(*args, **kw)

    def generate_sequence(self, mesh, hand, seq_cfg):
        return self.datasets.generate_sequence(mesh, hand, seq_cfg)

    def se3_exp(self, xi):
        return np.asarray(self._se3.se3_exp(jnp.asarray(np.asarray(xi), jnp.float32)))

    @staticmethod
    def start_from(tracker, pose):
        tracker.state = tracker.state._replace(
            pose=jnp.asarray(pose), initialized=jnp.asarray(True),
            fitness=jnp.asarray(1.0))

    @staticmethod
    def step(tracker, depth, hand_base, hand_q):
        res = tracker.step(jnp.asarray(depth), jnp.asarray(hand_base), jnp.asarray(hand_q))
        return np.asarray(res.pose), float(res.coverage), bool(res.reinitialized)

    @staticmethod
    def estimate(est, depth, prior, hand_base, hand_q, key, mode):
        return est.estimate(jnp.asarray(depth), jnp.asarray(prior), jnp.asarray(hand_base),
                            jnp.asarray(hand_q), key=key, mode=mode).pose

    @staticmethod
    def to_numpy(pose):
        return np.asarray(pose)

    @staticmethod
    def key(base, n, t, tag):
        return JaxDraws._key(base, n, t, tag)


class _Out(NamedTuple):
    pose: object
    fitness: float
    coverage: float
    reinitialized: bool


class _State(NamedTuple):
    pose: object
    initialized: object
    fitness: object


class Capture:
    """Runs a reference test function as it is, with its estimator, tracker
    and ADD-S stubbed, and records what the test hands the estimator: each
    frame (depth, hand base, joint values) with the key and mode of its
    estimate call, or the tracker's seed and start, and each ground truth
    it scores against. The stub's ADD-S is 1 m, so every init misses and
    each recovery view is rendered; the test's final assert then fails and
    is caught."""

    def __init__(self, module, test: str, *args):
        import pytest

        from icra20_hand_object_pose_tpu import evaluation

        self.calls, self.gts, self.cfgs, self.seeds, self.starts = [], [], [], [], []
        cap = self

        class Est:
            def __init__(self, obj, hand, cfg, *a, **k):
                self.obj, self.hand, self.cfg = obj, hand, cfg
                cap.cfgs.append(cfg)

            def estimate(self, depth, prior, hand_base=None, hand_q=None, key=None,
                         mode="track"):
                cap.calls.append((np.asarray(depth), np.asarray(hand_base),
                                  np.asarray(hand_q), key, mode))
                return _Out(jnp.eye(4), 0.0, 1.0, False)

        class Tr:
            def __init__(self, est, seed=0):
                self.est, self.state = est, _State(jnp.eye(4), jnp.asarray(False), 0.0)
                cap.seeds.append(seed)

            def step(self, depth, hand_base=None, hand_q=None):
                if not cap.calls:
                    cap.starts.append(np.asarray(self.state.pose)
                                      if bool(self.state.initialized) else None)
                cap.calls.append((np.asarray(depth), np.asarray(hand_base),
                                  np.asarray(hand_q), None, "step"))
                return _Out(jnp.eye(4), 0.0, 1.0, False)

        def adds(T_est, T_gt, pts):
            cap.gts.append(np.asarray(T_gt))
            return 1.0

        with pytest.MonkeyPatch.context() as mp:
            for name, stub in (("Estimator", Est), ("Tracker", Tr), ("add_s_error", adds)):
                if hasattr(module, name):
                    mp.setattr(module, name, stub)
            mp.setattr(evaluation, "add_s_error", adds)
            try:
                getattr(module, test)(*args)
            except AssertionError:
                pass


_BACKEND = None


def run_case(case: str, seed: int) -> dict:
    """One case at one seed with the JAX package (a worker keeps its models
    over the cases it runs)."""
    global _BACKEND
    if _BACKEND is None:
        _BACKEND = JaxBackend()
    r = G.run(case, seed, backend=_BACKEND, draws=JaxDraws())
    print(r.message(), f"({r.seconds:.1f} s)", flush=True)
    return {"seed": seed, "passed": r.passed, "stats": r.stats,
            "checks": [list(c) for c in r.checks], "seconds": r.seconds}


def _header(t0: float) -> dict:
    git = lambda *a: subprocess.run(["git", *a], cwd=ROOT, capture_output=True,  # noqa: E731
                                    text=True).stdout.strip()
    # the commit checked out, and whether the tree had changes beyond it
    commit = git("rev-parse", "HEAD") or None
    dirty = bool(git("status", "--porcelain", "--", "icra20_hand_object_pose_tpu",
                     "tests"))
    return {"command": "JAX_PLATFORMS=cpu python " + " ".join(
                [os.path.relpath(os.path.abspath(sys.argv[0]), ROOT)] + sys.argv[1:]),
            "commit": commit, "uncommitted_changes": dirty, "host": f"{socket.gethostname()} ({platform.processor() or platform.machine()}, {os.cpu_count()} cores)",
            "jax": jax.__version__, "seconds": round(time.perf_counter() - t0, 1)}


def gates(jobs: int) -> dict:
    """Every case over SEEDS seeds, in `jobs` worker processes."""
    import concurrent.futures as cf
    import multiprocessing as mp

    cases = list(G.CASES)
    tasks = [(c, s) for c in cases for s in range(SEEDS)]
    # the init-heavy cases first, so the pool ends on short tasks
    tasks.sort(key=lambda cs: not G.CASES[cs[0]].slow)
    done = {}
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")) as ex:
        futs = {ex.submit(run_case, c, s): (c, s) for c, s in tasks}
        for f in cf.as_completed(futs):
            done[futs[f]] = f.result()
    out = {}
    for c in cases:
        per = [done[(c, s)] for s in range(SEEDS)]
        out[c] = {"configuration": G.configuration(c), "checks": per[0]["checks"],
                  "passes": sum(p["passed"] for p in per), "seeds": SEEDS,
                  "per_seed": [{k: p[k] for k in ("seed", "passed", "stats")} for p in per]}
    return out


# ---------------------------------------------------------------------------
# The checks of tests/test_torch_gate_*.py
# ---------------------------------------------------------------------------

def cases_of(file: str, test: str) -> list:
    """pytest params of the cases of reference test `file::test`, each with
    the reference's own id (and marked `slow` where init-heavy)."""
    import pytest

    out = []
    for cid, c in G.CASES.items():
        if cid.split("[")[0] == f"{file}::{test}":
            pid = cid[len(f"{file}::{test}"):].strip("[]") or test
            out.append(pytest.param(cid, id=pid))
    return out


def gate_cases_of(file: str, test: str) -> list:
    import pytest

    return [pytest.param(*p.values, id=p.id,
                         marks=[pytest.mark.slow] if G.CASES[p.values[0]].slow else [])
            for p in cases_of(file, test)]


def reference_call(case: str):
    """(module, test name, args) of the reference test behind `case`, its
    parameters read from its own parametrize mark."""
    import importlib
    import inspect

    file, rest = case.split("::")
    module = importlib.import_module(file[:-3])
    test = rest.split("[")[0]
    fn = getattr(module, test)
    kw = {}
    for mark in getattr(fn, "pytestmark", []):
        if mark.name != "parametrize":
            continue
        names = [n.strip() for n in mark.args[0].split(",")]
        ids = mark.kwargs.get("ids")
        for i, vals in enumerate(mark.args[1]):
            vals = vals if isinstance(vals, (tuple, list)) else (vals,)
            pid = ids[i] if ids else "-".join(str(v) for v in vals)
            if case.endswith(f"[{pid}]"):
                kw = dict(zip(names, vals))
    params = list(inspect.signature(fn).parameters)
    if "estimators" in params:   # test_accuracy_regression.py's fixture
        kw["estimators"] = module.estimators.__wrapped__()
    return module, test, [kw[p] for p in params]


def _assert_depth_close(a, b):
    """tests/test_torch_sequence.py's raster tolerance: validity differs on
    at most 0.5% of the pixels, pixels valid in both agree to 1e-5 m."""
    va, vb = a > 0, b > 0
    assert np.mean(va != vb) <= 0.005
    both = va & vb
    assert both.sum() > 30
    np.testing.assert_allclose(a[both], b[both], atol=1e-5, rtol=0)


def check_scenario(case: str) -> None:
    """The inputs the reference test hands its estimator (captured from the
    test itself, `Capture`) against those the case module makes on
    the CPU with the reference's draws injected: every depth image (the
    raster's tolerance), reported hand base (1e-6), joint values (equal)
    and scored ground truth (1e-6), the estimator configuration, the
    tracker's seed and start; and the JAX package behind the same scenario code
    (what `port_gate_parity.py` measures) bitwise the test's inputs, with
    the test's keys."""
    import dataclasses as dc

    module, test, args = reference_call(case)
    cap = Capture(module, test, *args)
    port = G.scenario(case, device="cpu", draws=JaxDraws())
    ref = G.scenario(case, backend=JaxBackend(), draws=JaxDraws())
    assert len(port) == len(ref) == len(cap.calls) > 0, (len(port), len(ref), len(cap.calls))
    # the frames a test scores: all, or a tracked test's frames 1.. only
    scored = len(port) - len(cap.gts)
    assert scored in (0, 1), (len(port), len(cap.gts))
    for i, ((fp, key), (fr, rkey), (depth, hb, hq, ckey, mode)) in enumerate(
            zip(port, ref, cap.calls)):
        _assert_depth_close(fp.depth, depth)
        np.testing.assert_allclose(fp.hand_base, hb, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(fp.hand_q, hq)
        np.testing.assert_array_equal(fr.depth, depth)
        np.testing.assert_array_equal(fr.hand_base, hb)
        if i >= scored:
            np.testing.assert_allclose(fp.pose_gt, cap.gts[i - scored], atol=1e-6, rtol=0)
            np.testing.assert_array_equal(fr.pose_gt, cap.gts[i - scored])
        assert (key is None) == (ckey is None) and key == rkey
        if key is not None:
            assert mode == ("init" if key[3] is None else "track")
            assert (jax.random.key_data(JaxBackend.key(*key))
                    == jax.random.key_data(ckey)).all()
    cfg = G.configuration(case)["config"]
    assert {G._plain(dc.asdict(c)) == cfg for c in cap.cfgs} == {True}
    if cap.seeds:   # a tracked case: Tracker(est, seed=0), started as the case starts
        assert cap.seeds == [0]
        start = cap.starts[0]
        if start is None:
            assert G.CASES[case].slow or G.CASES[case].fn is G.concave_mug
        else:
            np.testing.assert_array_equal(start, port[0][0].pose_gt)


def reference_table() -> dict:
    return json.load(open(REFERENCE_JSON))


def check_gate(case: str) -> G.Result:
    """The port on the CPU at seed 0 with the reference's draws injected,
    held to the reference test's assertions. Where the reference itself
    failed an assertion on some of its S seeds (`torch_gate_reference.json`),
    that assertion holds the port to the reference's worst value of the
    statistic over the S seeds instead."""
    ref = reference_table()["cases"][case]
    r = G.run(case, 0, device="cpu", draws=JaxDraws())
    for c in r.checks:
        vals = [p["stats"][c.stat] for p in ref["per_seed"]]
        limit, how = c.limit, "the reference test's limit"
        if not all(c.holds(v) for v in vals):
            worst = vals[0]
            for v in vals[1:]:
                worst = c.worse(v, worst)
            limit, how = worst, (f"the reference's worst over its {len(vals)} seeds, "
                                 f"as it fails {c.limit:.4g} itself")
            ok = c.holds(r.stats[c.stat], limit) or r.stats[c.stat] == limit
        else:
            ok = c.holds(r.stats[c.stat])
        assert ok, (f"{case}: the port's {c.stat} {r.stats[c.stat]:.4g} is not "
                    f"{c.op} {limit:.4g} ({how}; the reference passes "
                    f"{ref['passes']}/{ref['seeds']}); {r.message()}")
    return r


def tiny_setup():
    """`__graft_entry__._tiny_setup`'s config and models at 160 x 120."""
    import __graft_entry__ as ge

    cfg, obj, hand, _ = ge._tiny_setup(cam_w=160, cam_h=120)
    return cfg, obj, hand


def track_stream(est, seq_dir: str, key: int) -> list[np.ndarray]:
    """The JAX Tracker at `key` over a saved sequence, read back through the
    JAX RecordedSequence (a cold start: frame 0 is an init)."""
    from icra20_hand_object_pose_tpu.datasets.sequence import RecordedSequence
    from icra20_hand_object_pose_tpu.models import Tracker

    tracker = Tracker(est, seed=key)
    out = []
    for fr in RecordedSequence(seq_dir):
        res = tracker.step(jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
                           jnp.asarray(fr.hand_q))
        out.append(np.asarray(res.pose))
    return out


def stream_distance(a, b, mesh) -> float:
    """d(a, b): the mean over frames of the ADD-S between two pose streams
    on the dense cloud (metres)."""
    from icra20_hand_object_pose_tpu.parity import compare_pose_sequences

    dense, _ = mesh.sample_surface(8192, seed=123)
    return float(compare_pose_sequences(a, b, dense).add_s_mean)


def tiny_sequence_config(seed: int, cam):
    from icra20_hand_object_pose_tpu.datasets import SyntheticSequenceConfig

    return SyntheticSequenceConfig(n_frames=STREAM_FRAMES, camera=cam, seed=seed)


def tiny_streams() -> dict:
    """(1) of `streams`: d(ref_j, ref_0) for keys j = 1..3 on each sequence
    seed, and the rule's k and m."""
    from icra20_hand_object_pose_tpu.datasets import generate_sequence
    from icra20_hand_object_pose_tpu.datasets.sequence import save_sequence
    from icra20_hand_object_pose_tpu.models import Estimator

    cfg, obj, hand = tiny_setup()
    est = Estimator(obj, hand, cfg)
    d = {}
    with tempfile.TemporaryDirectory() as work:
        for s in range(STREAM_SEEDS):
            seq_dir = os.path.join(work, f"seq{s}")
            save_sequence(generate_sequence(obj.mesh, hand,
                                            tiny_sequence_config(s, cfg.camera)),
                          cfg.camera, seq_dir)
            streams = [track_stream(est, seq_dir, k) for k in range(STREAM_KEYS)]
            d[s] = [1000.0 * stream_distance(streams[j], streams[0], obj.mesh)
                    for j in range(1, STREAM_KEYS)]
            print(f"tiny stream, sequence seed {s}: d(ref_j, ref_0) mm for j = 1..3: "
                  f"{[round(x, 3) for x in d[s]]}", flush=True)
    # the least k (m = 0) with which keys 2 and 3 pass on every seed: a
    # ratio, so it carries over to phase 7's VGA sequence
    k, m = max(x / d[s][0] for s in d for x in d[s][1:]), 0.0
    return {"sequence": {"frames": STREAM_FRAMES, "width": 160, "height": 120,
                         "setup": "__graft_entry__._tiny_setup(cam_w=160, cam_h=120)",
                         "shape": "box"},
            "sequence_seeds": STREAM_SEEDS, "keys": STREAM_KEYS,
            "d_mm": {str(s): v for s, v in d.items()}, "k": k, "m_mm": m}


def vga_streams() -> dict:
    """(2) of `streams`: keys 0 and 1 over phase 7's sequence (`cli demo`'s
    camera, config and sequence at VGA with 512 particles)."""
    import dataclasses

    from icra20_hand_object_pose_tpu.datasets import (
        SyntheticSequenceConfig, generate_sequence,
    )
    from icra20_hand_object_pose_tpu.datasets.sequence import save_sequence
    from icra20_hand_object_pose_tpu.models import Estimator, ObjectModel, make_t42_hand
    from icra20_hand_object_pose_tpu.utils import meshio
    from icra20_hand_object_pose_tpu.utils.config import CameraIntrinsics, EstimatorConfig

    w, h, p = DEMO["width"], DEMO["height"], DEMO["particles"]
    cam = CameraIntrinsics(width=w, height=h, fx=0.9 * w, fy=0.9 * w, cx=w / 2, cy=h / 2)
    cfg = EstimatorConfig(camera=cam)
    cfg = dataclasses.replace(
        cfg, pso=dataclasses.replace(cfg.pso, particles=p),
        tracker=dataclasses.replace(cfg.tracker, reinit_particles=2 * p))
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand()
    est = Estimator(ObjectModel(mesh, model_points=cfg.model_points), hand, cfg)
    with tempfile.TemporaryDirectory() as work:
        seq_dir = os.path.join(work, "sequence")
        save_sequence(generate_sequence(mesh, hand, SyntheticSequenceConfig(
            n_frames=DEMO["frames"], camera=cam)), cam, seq_dir)
        streams = {}
        for key in (0, 1):
            t0 = time.perf_counter()
            streams[key] = track_stream(est, seq_dir, key)
            print(f"VGA stream, key {key}: {time.perf_counter() - t0:.1f} s", flush=True)
    d = 1000.0 * stream_distance(streams[1], streams[0], mesh)
    print(f"VGA: d(ref_1, ref_0) = {d:.3f} mm", flush=True)
    return {"sequence": dict(DEMO, shape="box", config="EstimatorConfig() with "
                             "pso.particles and tracker.reinit_particles = 2 x "
                             "particles, as `cli demo --particles` sets them"),
            "streams": {str(k): [p.tolist() for p in v] for k, v in streams.items()},
            "d_ref1_ref0_mm": d}


def _plain_arrays(x):
    """JSON's view of a draw: arrays as (nested) lists of their float32
    values, which round-trip exactly."""
    if isinstance(x, np.ndarray):
        return x.astype(np.float32).tolist()
    if isinstance(x, list):
        return [_plain_arrays(v) for v in x]
    return x


def record_draws() -> dict:
    """`draws`: every gate case's jax.random draws at seeds 0 .. SEEDS - 1,
    one entry per distinct call (cases that share a key share its entry)."""
    calls = {}
    for case in G.CASES:
        for s in range(SEEDS):
            for c in G.draw_calls(case, s, JaxDraws()):
                key = G._draw_key(c["method"], c["args"])
                entry = {k: _plain_arrays(v) for k, v in c.items()}
                assert calls.setdefault(key, entry) == entry, key
    return {"seeds": list(range(SEEDS)), "calls": list(calls.values())}


_CS: dict = {}


def _config_select_setup() -> dict:
    """The frame, models and base configuration of tests/test_hand.py::
    test_config_select_recovers_evidence_under_wrong_nominal_q (the JAX
    package), built once a process."""
    if not _CS:
        from icra20_hand_object_pose_tpu.datasets import (
            default_object_pose, hand_base_for_grasp, render_frame_fast,
        )
        from icra20_hand_object_pose_tpu.models import ObjectModel, make_t42_hand
        from icra20_hand_object_pose_tpu.utils import meshio
        from icra20_hand_object_pose_tpu.utils.config import (
            CameraIntrinsics, EstimatorConfig, HandConfig, PsoConfig,
        )

        cam = CameraIntrinsics(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)
        hand = make_t42_hand(points_per_link=128)
        mesh = meshio.make_test_object("box")
        obj = ObjectModel(mesh, model_points=512, render_points=1024)
        pose = default_object_pose()
        hb = hand_base_for_grasp(pose)
        q_true = np.asarray([0.45, 0.45], np.float32)
        depth = jnp.asarray(render_frame_fast(mesh, pose, hand, hb, q_true, cam))
        base = EstimatorConfig(
            camera=cam, scene_points=1024, render_size=60,
            pso=PsoConfig(particles=64, iters=4),
            hand=HandConfig(config_samples=16, joint_sigma=0.2, config_select=0))
        from icra20_hand_object_pose_tpu.utils import se3 as jse3

        local, _ = mesh.sample_surface(8192, seed=123)
        dense = np.asarray(jse3.transform_points(jnp.asarray(pose), jnp.asarray(local)))
        _CS.update(hand=hand, dense=dense, obj=obj, pose=pose, hb=jnp.asarray(hb),
                   q_wrong=jnp.asarray(q_true + 0.3), depth=depth, base=base, ests={})
    return _CS


def _reference_hand(normals):
    """The reference test's hand; with `normals` ([K,J] unit normals) a copy
    whose `sampled_clouds` serves those finger configurations in place of its
    own draw, with the package's arithmetic."""
    import copy

    hand = _config_select_setup()["hand"]
    if normals is None:
        return hand
    hand = copy.copy(hand)

    def sampled_clouds(key, base_pose, q_nominal, sigma, n_samples):
        noise = jnp.asarray(np.asarray(normals, np.float32)[:n_samples]) * sigma
        noise = noise.at[0].set(0.0)
        qs = jnp.clip(q_nominal[None] + noise, 0.0, jnp.pi)
        return jax.vmap(lambda q: hand.cloud(base_pose, q))(qs)

    hand.sampled_clouds = sampled_clouds
    return hand


def _reference_estimators(normals) -> dict:
    """The test's two estimators ("union", config_select 0; "select", 3) on
    `_reference_hand(normals)`: new ones (and so new traces) for injected
    samples, else one pair a process."""
    import dataclasses

    from icra20_hand_object_pose_tpu.models import Estimator

    c = _config_select_setup()
    if normals is None and c["ests"]:
        return c["ests"]
    hand = _reference_hand(normals)
    ests = {name: Estimator(c["obj"], hand, dataclasses.replace(
        c["base"], hand=dataclasses.replace(c["base"].hand, config_select=sel)))
        for name, sel in (("union", 0), ("select", 3))}
    if normals is None:
        c["ests"] = ests
    return ests


def reference_scene_prep(est, key: int):
    """(scene points [n,3] where the weight is set, their count) of `est`'s
    scene prep of the test's frame at jax.random.key(key)."""
    c = _config_select_setup()
    prep = c.setdefault("preps", {}).get(id(est))
    if prep is None or prep[0] is not est:
        prep = c["preps"][id(est)] = (est, jax.jit(est._scene_prep,
                                                   static_argnames="init_scoring"))
    k_hand, k_pre, _, _ = jax.random.split(jax.random.key(key), 4)
    scene, w, *_ = prep[1](k_hand, k_pre, c["depth"], c["hb"], c["q_wrong"],
                           init_scoring=False)
    w = np.asarray(w)
    return np.asarray(scene.points)[w > 0], float(w.sum())


def config_select_run(key: int, normals=None) -> dict:
    """The body of tests/test_hand.py::
    test_config_select_recovers_evidence_under_wrong_nominal_q with
    jax.random.key(key) for key(0) (the test file unchanged): per
    configuration the estimate's scene points and ADD-S and the scene
    prep's point count, and both assertions. With `normals` ([16,2], the
    port's draw at seed `key`), the reference's hand draws those finger
    samples in place of its own: the scene of the port's run at that seed,
    the rest of the frame on the reference's key. `off_object`: the scene
    prep's points off the object (`_off_object`)."""
    from icra20_hand_object_pose_tpu.evaluation import add_s_error

    c = _config_select_setup()
    out = {"key" if normals is None else "seed": key}
    if normals is not None:
        out["normals"] = np.asarray(normals, np.float32).tolist()
    for name, est in _reference_estimators(normals).items():
        res = est.estimate(c["depth"], jnp.asarray(c["pose"]), c["hb"], c["q_wrong"],
                           key=jax.random.key(key))
        pts, n = reference_scene_prep(est, key)
        out[name] = {"n_scene": float(res.n_scene), "scene_prep_points": n,
                     "off_object": _off_object(pts, c["dense"]),
                     "adds_m": float(add_s_error(np.asarray(res.pose), c["pose"],
                                                 c["obj"].model_pts))}
    u, sel = out["union"], out["select"]
    out["evidence"] = sel["n_scene"] >= u["n_scene"] + 5
    out["tracking"] = sel["adds_m"] < max(1.5 * u["adds_m"], 0.006)
    out["passed"] = out["evidence"] and out["tracking"]
    print(f"config_select, reference {'own key' if normals is None else 'on the port samples'}"
          f" {key}: {out}", flush=True)
    return out


def _port_scene():
    import torch

    import test_torch_hand_behaviour as H

    torch.set_num_threads(2)
    return H, H.make_scene()


def config_select_port_run(seed: int) -> dict:
    """The port's run of the test's body at `seed` on its own stream
    (test_torch_hand_behaviour.config_select_run, nothing injected):
    finger-sample normals, per configuration scene points and ADD-S, both
    assertions."""
    H, sc = _port_scene()
    out = H.config_select_run(sc, seed)
    print(f"config_select, port on its own stream, seed {seed}: {out}", flush=True)
    return out


def config_select_on_port_samples(seed: int) -> dict:
    """config_select_run at `seed` on the finger samples the port's hand
    draws at that seed."""
    H, sc = _port_scene()
    return config_select_run(seed, H.first_stage(sc, seed)["normals"])


def selection_recovery() -> dict:
    """Per package, the share of seeds k < RECOVERY_DRAWS on which its own
    first stage (nothing injected: the finger samples drawn at seed k, the
    scene prep of the test's frame) keeps the 5 more scene points the
    evidence assertion asks of the selection: the reference's at
    jax.random.key(k), the port's at its generator seeded k."""
    H, sc = _port_scene()
    ref_ests = _reference_estimators(None)
    out = {"draws": RECOVERY_DRAWS}
    for name, gap in (
            ("reference", lambda k: (reference_scene_prep(ref_ests["select"], k)[1]
                                     - reference_scene_prep(ref_ests["union"], k)[1])),
            ("port", lambda k: (lambda r: r["select"]["scene_prep_points"]
                                - r["union"]["scene_prep_points"])(H.first_stage(sc, k)))):
        ok = [bool(gap(k) >= 5) for k in range(RECOVERY_DRAWS)]
        out[name] = {"share": sum(ok) / RECOVERY_DRAWS, "first_16": sum(ok[:16]),
                     "per_seed": ok}
        print(f"selection recovery, {name}: {sum(ok)}/{RECOVERY_DRAWS}, "
              f"first 16: {sum(ok[:16])}", flush=True)
    return out


def _off_object(points: np.ndarray, dense: np.ndarray) -> int:
    """How many scene points lie farther than OFF_OBJECT_M from the
    object's surface at the true pose (`dense`, posed surface samples)."""
    d2 = ((points[:, None, :] - dense[None]) ** 2).sum(-1).min(1)
    return int((d2 > OFF_OBJECT_M ** 2).sum())


def seed0_trace() -> dict:
    """The port's failing seed 0, stage by stage against the reference on
    the same inputs: the port's seed-0 finger samples S0 in both packages.
    (1) The scene prep of each configuration: point counts, how many of
    the port's points have no counterpart in the reference's cloud and the
    largest nearest-neighbour distance between the two clouds (the
    preprocessing subsample takes its own draw in each package), and how
    many points lie off the object at the true pose. (2) The search:
    S0 fixed, each configuration's ADD-S over search seeds 0 ..
    TRACE_SEARCH_SEEDS - 1, the port on its generator seeded k, the
    reference on jax.random.key(k), and how often the tracking assertion
    holds."""
    import torch

    from icra20_hand_object_pose_tpu.evaluation import add_s_error as ref_add_s
    from icra20_hand_object_pose_tpu_torch.evaluation import add_s_error
    from icra20_hand_object_pose_tpu_torch.models import Estimator
    from icra20_hand_object_pose_tpu_torch.utils import rng

    H, sc = _port_scene()
    c = _config_select_setup()
    s0 = H.first_stage(sc, 0)["normals"]
    dense = c["dense"]
    ref_ests = _reference_estimators(s0)
    hand = sc["hand"]
    serve = H.fixed_samples(hand, s0)

    def sampled_clouds(gen, base_pose, q_nominal, sigma, n_samples):
        # the port's own draw is taken and set aside, so that search seed 0
        # is the port's own run of seed 0
        rng.normal(gen, (n_samples, hand.n_joints))
        return serve(gen, base_pose, q_nominal, sigma, n_samples)

    hand.sampled_clouds = sampled_clouds
    try:
        port_ests = {name: Estimator(sc["obj"], hand, H._cfg(sc["base"], sel))
                     for name, sel in H.CONFIGS}
        prep = {}
        for name, est in port_ests.items():
            scene, w, *_ = est._scene_prep(torch.Generator().manual_seed(0), *(
                est._tensor(sc[k]) for k in ("depth", "hb", "q_wrong")))
            p_pts = scene.points[w > 0].numpy()
            r_pts, r_n = reference_scene_prep(ref_ests[name], 0)
            nn = np.sqrt(((p_pts[:, None] - r_pts[None]) ** 2).sum(-1))
            prep[name] = {
                "port_points": int(len(p_pts)), "reference_points": int(r_n),
                "points_unmatched": int((nn.min(1) > 1e-6).sum()),
                "max_nn_distance_m": float(max(nn.min(1).max(), nn.min(0).max())),
                "port_off_object": _off_object(p_pts, dense),
                "reference_off_object": _off_object(r_pts, dense)}
        search = {"port": [], "reference": []}
        for k in range(TRACE_SEARCH_SEEDS):
            e = {}
            for name, est in port_ests.items():
                res = est.estimate(sc["depth"], sc["pose"], sc["hb"], sc["q_wrong"], key=k)
                e[name] = add_s_error(res.pose.numpy(), sc["pose"], sc["model_pts"])
            search["port"].append(e)
        for k in range(TRACE_SEARCH_SEEDS):
            e = {}
            for name, est in ref_ests.items():
                res = est.estimate(c["depth"], jnp.asarray(c["pose"]), c["hb"], c["q_wrong"],
                                   key=jax.random.key(k))
                e[name] = float(ref_add_s(np.asarray(res.pose), c["pose"], c["obj"].model_pts))
            search["reference"].append(e)
    finally:
        del hand.sampled_clouds
    out = {"normals": s0, "scene_prep": prep, "off_object_m": OFF_OBJECT_M,
           "search_seeds": TRACE_SEARCH_SEEDS, "adds_m": search}
    for who, runs in search.items():
        out[f"{who}_tracking_holds"] = sum(
            r["select"] < max(1.5 * r["union"], 0.006) for r in runs)
    print(f"seed-0 trace: {out}", flush=True)
    return out


def behaviour(jobs: int) -> dict:
    """`behaviour`: over seeds 0 .. BEHAVIOUR_KEYS - 1, the reference's runs
    of the config-selection test's body on its own keys, the port's on its
    own stream, and the reference's on the port's finger samples (the
    scenes the port's runs drew); the selection's evidence rate over
    RECOVERY_DRAWS seeds in each package; the trace of the port's seed 0."""
    import concurrent.futures as cf
    import multiprocessing as mp

    seeds = range(BEHAVIOUR_KEYS)
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")) as ex:
        own = ex.map(config_select_run, seeds)
        port = ex.map(config_select_port_run, seeds)
        on_port = ex.map(config_select_on_port_samples, seeds)
        trace = ex.submit(seed0_trace)
        recovery = ex.submit(selection_recovery)
        own, port, on_port = list(own), list(port), list(on_port)
        trace, recovery = trace.result(), recovery.result()
    return {"test_hand.py::test_config_select_recovers_evidence_under_wrong_nominal_q": {
        "keys": BEHAVIOUR_KEYS, "passes": sum(r["passed"] for r in own), "per_key": own,
        "port_own_stream": {"seeds": BEHAVIOUR_KEYS, "passes": sum(r["passed"] for r in port),
                            "per_seed": port},
        "reference_on_port_samples": {"seeds": BEHAVIOUR_KEYS,
                                      "passes": sum(r["passed"] for r in on_port),
                                      "per_seed": on_port},
        "selection_recovery": recovery, "seed0_trace": trace}}


def occlusion_cpu_run(level: str, seed: int, draws: str) -> float:
    """The port's max tracked ADD-S (mm) of occlusion case `level` at `seed`
    on the CPU, on the reference's scenes (draws "reference":
    RecordedDraws) or the port's (draws "port": PortDraws)."""
    import torch

    torch.set_num_threads(2)
    d = G.RecordedDraws() if draws == "reference" else G.PortDraws()
    r = G.run(f"test_occlusion_gate.py::test_tracking_under_occlusion[{level}]", seed,
              device="cpu", draws=d)
    print(f"occlusion {level} seed {seed}, {draws} draws: {r.stats['max_adds_mm']:.3f} mm",
          flush=True)
    return r.stats["max_adds_mm"]


def stage_record(jobs: int) -> dict:
    """`stages`: the port's staged runs on the CPU (torch_gate_cases.
    staged_occlusion, the reference's recorded scenes, host draws), and the
    port's max tracked ADD-S at the stage levels over seeds 0 .. SEEDS - 1
    on the CPU, on the reference's scenes and on the port's (PortDraws,
    phase 17's scenes before they were recorded)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    import torch

    torch.set_num_threads(4)
    runs = []
    for level in G.STAGE_LEVELS:
        for s in G.STAGE_SEEDS:
            t0 = time.perf_counter()
            runs.append(G.staged_occlusion(level, s, "cpu"))
            print(f"stages {level} seed {s}: max ADD-S {runs[-1]['max_adds_mm']:.3f} mm "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    tasks = [(lv, s, d) for lv in G.STAGE_LEVELS for d in ("reference", "port")
             for s in range(SEEDS)]
    with cf.ProcessPoolExecutor(jobs, mp_context=mp.get_context("spawn")) as ex:
        vals = list(ex.map(occlusion_cpu_run, *zip(*tasks)))
    table = {}
    for (lv, s, d), v in zip(tasks, vals):
        table.setdefault(lv, {}).setdefault(f"{d}_draws", []).append(v)
    return {"torch": torch.__version__, "runs": runs, "occlusion_cpu_max_adds_mm": table}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=3,
                    help="worker processes of the gates and of the behaviour runs")
    ap.add_argument("--only", choices=["gates", "streams", "draws", "behaviour", "stages"],
                    default=None)
    args = ap.parse_args()
    t0 = time.perf_counter()
    for only, path, make in (("draws", G.DRAWS_JSON, record_draws),
                             ("behaviour", BEHAVIOUR_JSON, lambda: behaviour(args.jobs)),
                             ("stages", G.STAGES_JSON, lambda: stage_record(args.jobs))):
        if args.only in (None, only):
            t1 = time.perf_counter()
            rec = make()
            json.dump(dict(_header(t1), **rec), open(path, "w"))
    if args.only in (None, "gates"):
        table = gates(args.jobs)
        # the streams' entry, when this run does not remake it
        old = json.load(open(REFERENCE_JSON)) if os.path.exists(REFERENCE_JSON) else {}
        rec = dict(_header(t0), seeds=SEEDS, cases=table)
        if "pose_stream" in old:
            rec["pose_stream"] = old["pose_stream"]
        json.dump(rec, open(REFERENCE_JSON, "w"), indent=1)
        for c, e in table.items():
            print(f"{c}: {e['passes']}/{e['seeds']}", flush=True)
    if args.only in (None, "streams"):
        t1 = time.perf_counter()
        tiny = tiny_streams()
        rec = json.load(open(REFERENCE_JSON)) if os.path.exists(REFERENCE_JSON) else {}
        rec["pose_stream"] = dict(tiny, **_header(t1))
        json.dump(rec, open(REFERENCE_JSON, "w"), indent=1)
        t2 = time.perf_counter()
        json.dump(dict(vga_streams(), **_header(t2)), open(STREAM_JSON, "w"), indent=1)


if __name__ == "__main__":
    main()
