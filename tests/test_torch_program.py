"""The port's compiled programs (utils/program.py, the counterpart of the
JAX package's `jax.jit` of `Estimator._frame_step` and of the library
sweep) on the CPU, where a program calls its traced function directly:

- the keys: one program per mode and prior shape, keyed by the reference's
  static arguments, the mode's scalars and the inputs' shapes;
- what a capture on the card needs, held here: no host read and no copy
  from the host inside `_frame_step` and the sweep's `_sweep_step`, in both
  modes, per scene and shared, with the tracer (utils/profiling.py) off
  and on (its stage marks inside);
- `estimate` bitwise `_frame_step` at the same seed, and a result untouched
  by the next call;
- an int seed draws the stream of `torch.Generator().manual_seed(seed)`
  from offset 0, the stream a program reseeds to before every replay.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.models.estimator import _generator
from icra20_hand_object_pose_tpu_torch.ops import knn_cuda
from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep
from icra20_hand_object_pose_tpu_torch.utils import meshio, profiling, program, rng
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

torch.set_num_threads(2)

# the reference's static_argnames of `Estimator._step_jit`
# (icra20_hand_object_pose_tpu/models/estimator.py)
REFERENCE_STATICS = ("n_particles", "pso_iters", "resample_after", "prescreen",
                     "init_scoring")
MODE_SCALARS = ("rot_sigma", "trans_sigma", "roi_radius")


@pytest.fixture(scope="module")
def tiny():
    """__graft_entry__._tiny_setup's size on the port alone: 64 x 48, 256
    scene points, 16 particles x 3 iterations, a 64-orientation prescreen;
    box and cylinder, one frame each."""
    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    cfg = EstimatorConfig(
        camera=cam, scene_points=256, render_size=48,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=64),
    )
    hand = make_t42_hand(points_per_link=64, device="cpu")
    meshes = [meshio.make_test_object(s) for s in ("box", "cylinder")]
    objs = [ObjectModel(m, model_points=256, render_points=512, seed=i, device="cpu")
            for i, m in enumerate(meshes)]
    frames = [generate_sequence(m, hand, SyntheticSequenceConfig(
        n_frames=1, camera=cam, noise_sigma=0.0), device="cpu")[0] for m in meshes]
    return dict(cfg=cfg, hand=hand, objs=objs, frames=frames)


def _fused(cfg):
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, fused_gn=True))


def _args(fr, mode):
    prior = np.eye(4, dtype=np.float32) if mode == "init" else fr.pose_gt
    return fr.depth, prior, fr.hand_base, fr.hand_q


def test_program_keys(tiny):
    """Two track frames build one program, track and init two, a [2,4,4]
    prior (the motion prior's stack) a third; a fused_gn estimator keeps
    programs of its own. A key's static fields are the reference's
    static_argnames that the mode sets plus its scalars, then the inputs'
    shapes, the number of seeds and the device. On the CPU a program holds
    no graph and its owner no memory pool."""
    cfg, fr = tiny["cfg"], tiny["frames"][0]
    est = Estimator(tiny["objs"][0], tiny["hand"], cfg)
    for seed in (1, 2):
        est.estimate(*_args(fr, "track"), key=seed, mode="track")
    assert len(est._programs) == 1
    est.estimate(*_args(fr, "init"), key=3, mode="init")
    assert len(est._programs) == 2
    est.estimate(fr.depth, np.stack([fr.pose_gt] * 2), fr.hand_base, fr.hand_q,
                 key=4, mode="track")
    assert len(est._programs) == 3
    fused = Estimator(tiny["objs"][0], tiny["hand"], _fused(cfg))
    fused.estimate(*_args(fr, "track"), key=1, mode="track")
    assert len(fused._programs) == 1 and len(est._programs) == 3

    keys = list(est._programs.programs)
    track, init = keys[0], keys[1]
    assert {k for k, _ in track[0]} == set(MODE_SCALARS) | {"n_particles", "pso_iters"}
    assert {k for k, _ in init[0]} == set(MODE_SCALARS) | set(REFERENCE_STATICS)
    assert track[1] == ((48, 64), (4, 4), (4, 4), (2,)) and keys[2][1][1] == (2, 4, 4)
    assert track[2] == 1 and track[3] == torch.device("cpu")
    # the CPU's programs call their functions: no graph, so no memory pool
    assert est._programs.pool is None and est._programs.pool_bytes() == 0


class _NoHostRead(TorchDispatchMode):
    """Raises on the operators that read a tensor's value on the host (a
    scalar read, an index list, an eigensolver's status check), and on an
    indexed assignment of a 0-dim value: `x[idx] = 0.5` wraps the number
    on the host and copies it to the card."""

    BANNED = {"aten::_local_scalar_dense", "aten::nonzero", "aten::_linalg_eigh",
              "aten::masked_select"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func._schema.name
        if name in self.BANNED:
            raise AssertionError(f"host read in a program body: {func}")
        if name in ("aten::index_put_", "aten::index_put") and args[2].dim() == 0:
            raise AssertionError(f"a host number assigned in a program body: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_reads(monkeypatch, copies: bool = False):
    """Inside the block a read of a tensor on the host raises (and, with
    `copies`, so does a tensor made from host data): what a CUDA graph's
    capture forbids."""
    def banned(name):
        def fail(*args, **kwargs):
            raise AssertionError(f"{name} in a program body")
        return fail

    with monkeypatch.context() as mp:
        for name in ("item", "__bool__", "__float__", "__int__", "__index__",
                     "tolist", "numpy", "cpu"):
            mp.setattr(torch.Tensor, name, banned(f"Tensor.{name}"))
        mp.setattr(torch, "nonzero", banned("torch.nonzero"))
        if copies:
            for name in ("tensor", "as_tensor", "from_numpy"):
                mp.setattr(torch, name, banned(f"torch.{name}"))
        with _NoHostRead():
            yield


@contextlib.contextmanager
def _tracing(on: bool):
    """The tracer on or off inside the block, reset after."""
    was = profiling.tracing(on)
    try:
        yield
    finally:
        profiling.tracing(was)
        profiling.reset()


def _variant(tiny, variant):
    """An estimator of phase 18's programs: the default (K1), fused_gn
    (K3), nn_fn (K2) and pixel-mode scoring."""
    cfg, kw = tiny["cfg"], {}
    if variant == "fused_gn":
        cfg = _fused(cfg)
    elif variant == "nn_fn":
        kw = dict(nn_fn=knn_cuda.make_nn_fn())
    elif variant == "pixel":
        cfg = dataclasses.replace(cfg, score=dataclasses.replace(cfg.score, mode="pixel"))
    return Estimator(tiny["objs"][0], tiny["hand"], cfg, **kw)


@pytest.mark.parametrize("variant", ["default", "fused_gn", "nn_fn", "pixel",
                                     "two_priors"])
@pytest.mark.parametrize("mode", ["init", "track"])
@pytest.mark.parametrize("tracing", [False, True], ids=["untraced", "traced"])
def test_frame_step_has_no_host_reads(tiny, monkeypatch, tracing, mode, variant):
    """`_frame_step` in both modes, through K1's, K3's and K2's plain
    versions, in pixel mode and with two priors, reads nothing on the host
    and copies nothing from it (after one warm call, as a program's warm-up
    fills its constants), with the tracer off and on (its stage marks);
    traced, it is bitwise the untraced call."""
    est = _variant(tiny, variant)
    depth, prior, hb, hq = _args(tiny["frames"][0], mode)
    if variant == "two_priors":
        prior = np.stack([prior] * 2)
    dyn, static = est.frame_args(depth, prior, hb, hq, key=3, mode=mode)
    ref = est._frame_step(*dyn, **static)
    dyn = (_generator(3, est.device),) + dyn[1:]
    with _tracing(tracing), _no_host_reads(monkeypatch, copies=True):
        out = est._frame_step(*dyn, **static)
    for name, a, b in zip(out._fields, out, ref):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("mode", ["init", "track"])
@pytest.mark.parametrize("tracing", [False, True], ids=["untraced", "traced"])
def test_sweep_has_no_host_reads(tiny, monkeypatch, tracing, mode, shared):
    """`LibrarySweep._run` of two objects in both modes, per scene and on a
    shared scene, reads nothing on the host, and its traced `_sweep_step`
    copies nothing from it, with the tracer off and on; traced, both are
    bitwise the untraced call."""
    frames = tiny["frames"]
    sweep = LibrarySweep(tiny["objs"], tiny["hand"], tiny["cfg"], shared_scene=shared)
    if shared:
        depths, hbs, hqs = frames[0].depth, frames[0].hand_base, frames[0].hand_q
    else:
        depths, hbs, hqs = (np.stack([getattr(f, n) for f in frames])
                            for n in ("depth", "hand_base", "hand_q"))
    prev = np.stack([_args(f, mode)[1] for f in frames])
    ref = sweep._run([5, 6], depths, prev, hbs, hqs, mode)
    with _tracing(tracing), _no_host_reads(monkeypatch):
        out = sweep._run([5, 6], depths, prev, hbs, hqs, mode)
    inputs = [torch.as_tensor(a, dtype=torch.float32) for a in (depths, prev, hbs, hqs)]
    gens = rng.Stack([_generator(k, sweep.device) for k in (5, 6)])
    static = sweep._statics(mode)
    with _tracing(tracing), _no_host_reads(monkeypatch, copies=True):
        traced = sweep._sweep_step(gens, *inputs, **static)
    for name, a, b, c in zip(out._fields, out, ref, traced):
        assert torch.equal(a, b) and torch.equal(a, c), name


@pytest.mark.parametrize("mode", ["init", "track"])
def test_estimate_matches_frame_step_and_keeps_results(tiny, mode):
    """`estimate` (the program) bitwise `_frame_step` (eager) at the same
    int seed, every field; a result stays as it was after the next call."""
    est = Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"])
    fr = tiny["frames"][0]
    outs = [est.estimate(*_args(fr, mode), key=seed, mode=mode) for seed in (7, 8)]
    kept = [tuple(t.clone() for t in out) for out in outs]
    for seed, out in zip((7, 8), outs):
        dyn, static = est.frame_args(*_args(fr, mode), key=seed, mode=mode)
        eager = est._frame_step(*dyn, **static)
        for name, a, b in zip(out._fields, out, eager):
            assert torch.equal(a, b), (seed, name)
    est.estimate(*_args(fr, mode), key=9, mode=mode)
    for out, before in zip(outs, kept):
        assert all(torch.equal(a, b) for a, b in zip(out, before))


def test_tracker_state_survives_the_next_frame(tiny):
    """`Tracker.step` keeps the frame's pose, fitness and coverage in its
    state; the next frame's program leaves them as they were."""
    fr = tiny["frames"][0]
    tracker = Tracker(Estimator(tiny["objs"][0], tiny["hand"], tiny["cfg"]), seed=0)
    tracker.state = tracker.state._replace(pose=fr.pose_gt, initialized=True,
                                           fitness=1.0)
    tracker.step(fr.depth, fr.hand_base, fr.hand_q)
    st = tracker.state
    kept = [t.clone() for t in (st.pose, st.fitness, st.coverage)]
    tracker.step(fr.depth, fr.hand_base, fr.hand_q)
    assert all(torch.equal(a, b) for a, b in zip((st.pose, st.fitness, st.coverage), kept))


def test_int_seed_draws_the_reseeded_stream():
    """A program's generators, reseeded with `manual_seed` after any number
    of draws, give the draws of a fresh `torch.Generator().manual_seed`, as
    `_generator` builds it for an eager call: each from offset 0."""
    prog = program.Program(torch.device("cpu"), 2)
    fresh = [_generator(s, torch.device("cpu")) for s in (11, 12)]
    want = [torch.randn((5, 3), generator=g) for g in fresh]
    want_perm = [torch.randperm(64, generator=g) for g in fresh]
    for _ in range(2):
        prog._seed([11, 12])
        src = rng.Stack(prog.gens)
        assert torch.equal(rng.normal(src, (5, 3)), torch.stack(want))
        assert torch.equal(rng.permutation(src, 64), torch.stack(want_perm))
