"""The port's LibrarySweep (parallel/sharding.py) on the CPU, at the size of
tests/test_sharding.py's fixture (64x48, 16 particles, 3 iterations, 256
scene points):

- against itself: `_run` at O = 1 bitwise `Estimator.estimate` with the same
  seed, both programs; object o of an O = 3 sweep bitwise the single-object
  estimate with object o's seed (every reduction of the search runs along
  an axis the object axis does not touch, and the kernels' plain versions
  compute each object apart, so no tolerance is needed on the CPU);
  shared-scene object 0 bitwise the per-scene path on copies of the frame,
  also under fused_gn, where every K3 call gets a scene per object;
- against the JAX package's LibrarySweep on the same frames: result shapes,
  the `reinitialized` masks of forced states, `vel_ok` over three steps
  under a motion prior, the hypothesis slots at H = 2, and dense ADD-S. The
  two draw different random numbers, so poses are compared by error: the
  port's mean ADD-S within max(reference mean + 3 mm, 5 mm), the rule of
  tests/test_torch_estimator.py;
- the constructor's and step's errors, checkpoints both ways, `cli sweep`.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu import evaluation
from icra20_hand_object_pose_tpu.datasets import (
    SyntheticSequenceConfig as JaxSequenceConfig,
    generate_sequence as jax_generate_sequence,
)
from icra20_hand_object_pose_tpu.models import (
    ObjectModel as JaxObjectModel, make_t42_hand as jax_t42,
)
from icra20_hand_object_pose_tpu.parallel import LibrarySweep as JaxLibrarySweep
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio
from icra20_hand_object_pose_tpu_torch import cli, convert
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.datasets.sequence import save_sequence
from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker
from icra20_hand_object_pose_tpu_torch.models.estimator import _split
from icra20_hand_object_pose_tpu_torch.parallel import (
    LibrarySweep, SweepResult, SweepState,
)
from icra20_hand_object_pose_tpu_torch.parallel.sharding import frame_seeds
from icra20_hand_object_pose_tpu_torch.utils import meshio, rng
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

torch.set_num_threads(2)
SHAPES = ["box", "cylinder", "sphere"]


def _port_object(obj):
    return convert.object_from_numpy(
        **{f: np.asarray(getattr(obj, f)) for f in (
            "model_pts", "model_normals", "render_pts", "render_normals",
            "render_w", "symmetries")},
        diameter=obj.diameter, mesh=obj.mesh, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    """tests/test_sharding.py's fixture, and the port's models built from
    the same arrays: three objects of three shapes, one frame each."""
    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    cfg = EstimatorConfig(
        camera=cam, scene_points=256, render_size=48,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=64),
    )
    hand = jax_t42(points_per_link=64)
    thand = convert.hand_from_numpy(
        link_pts=np.asarray(hand._link_pts),
        link_normals=np.asarray(hand._link_normals),
        origins=np.asarray(hand._origins), links=hand.links,
        n_joints=hand.n_joints, device="cpu")
    objs, frames = [], []
    for i, shape in enumerate(SHAPES):
        mesh = jmeshio.make_test_object(shape)
        objs.append(JaxObjectModel(mesh, model_points=256, render_points=512, seed=i))
        frames.append(jax_generate_sequence(
            mesh, hand, JaxSequenceConfig(n_frames=1, camera=cam,
                                          noise_sigma=0.0, dropout=0.0))[0])
    tobjs = [_port_object(o) for o in objs]
    dense = [o.mesh.sample_surface(4096, seed=5)[0] for o in objs]
    return dict(cfg=cfg, hand=hand, thand=thand, objs=objs, tobjs=tobjs,
                frames=frames, dense=dense)


def _inputs(frames):
    return (np.stack([f.depth for f in frames]),
            np.stack([f.hand_base for f in frames]),
            np.stack([f.hand_q for f in frames]))


def _adds_mm(poses, frames, dense):
    return [1000.0 * evaluation.add_s_error(np.asarray(p), f.pose_gt, d)
            for p, f, d in zip(poses, frames, dense)]


def _cfg(cfg, **tracker):
    return dataclasses.replace(cfg, tracker=dataclasses.replace(cfg.tracker, **tracker))


# -- (b) the port against itself ---------------------------------------------

@pytest.mark.parametrize("mode", ["init", "track"])
def test_sweep_of_one_matches_single_object(tiny, mode):
    """Counterpart of test_sweep_init_matches_single_object_init: the O = 1
    sweep program IS the single-object program, bitwise, init and track."""
    cfg, fr = tiny["cfg"], tiny["frames"][0]
    sweep = LibrarySweep(tiny["tobjs"][:1], tiny["thand"], cfg)
    est = Estimator(tiny["tobjs"][0], tiny["thand"], cfg)
    prev = np.eye(4, dtype=np.float32) if mode == "init" else fr.pose_gt
    single = est.estimate(fr.depth, prev, fr.hand_base, fr.hand_q, key=5, mode=mode)
    out = sweep._run([5], fr.depth[None], prev[None], fr.hand_base[None],
                     fr.hand_q[None], mode)
    assert out.pose.shape == (1, 4, 4) and out.fitness_trace.shape[0] == 1
    for name, a, b in zip(out._fields, out, single):
        assert torch.equal(a[0], b), name


@pytest.mark.parametrize("variant", ["default", "fused_gn", "nn_fn", "pixel",
                                     "two_hypotheses"])
@pytest.mark.parametrize("mode", ["init", "track"])
def test_sweep_object_matches_its_single_estimate(tiny, mode, variant):
    """Object o of an O = 3 sweep (three shapes, three frames, seeds 5, 6, 7)
    is bitwise the single-object estimate with object o's seed: through K1's
    plain version, K3's (fused_gn), K2's (nn_fn), pixel-mode scoring and two
    hypothesis priors."""
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda

    cfg, frames = tiny["cfg"], tiny["frames"]
    kw = {}
    if variant == "fused_gn":
        cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, fused_gn=True))
    elif variant == "nn_fn":
        kw = dict(nn_fn=knn_cuda.make_nn_fn())
    elif variant == "pixel":
        cfg = dataclasses.replace(cfg, score=dataclasses.replace(cfg.score, mode="pixel"))
    elif variant == "two_hypotheses":
        cfg = _cfg(cfg, n_hypotheses=2)
    depths, hbs, hqs = _inputs(frames)
    prev = np.stack([np.eye(4, dtype=np.float32) if mode == "init" else f.pose_gt
                     for f in frames])
    if variant == "two_hypotheses":
        prev = np.repeat(prev[:, None], 2, axis=1)
    out = LibrarySweep(tiny["tobjs"], tiny["thand"], cfg, **kw)._run(
        [5, 6, 7], depths, prev, hbs, hqs, mode)
    assert out.pose.shape == (3, 4, 4) and out.hyp_poses.shape[:2] == (3, prev.ndim - 2)
    for o in range(3):
        single = Estimator(tiny["tobjs"][o], tiny["thand"], cfg, **kw).estimate(
            depths[o], prev[o], hbs[o], hqs[o], key=5 + o, mode=mode)
        for name, a, b in zip(out._fields, out, single):
            assert torch.equal(a[o], b), (SHAPES[o], name)


def _shared_scene_object0(tiny, cfg, mode="init"):
    """Object 0 of the shared-scene sweep of the first two models against
    the per-scene path fed copies of the frame with the same seeds (5, 6):
    every result field bitwise. Returns the shared-scene sweep."""
    fr = tiny["frames"][0]
    objs = tiny["tobjs"][:2]
    per = LibrarySweep(objs, tiny["thand"], cfg)
    sh = LibrarySweep(objs, tiny["thand"], cfg, shared_scene=True)
    prev = np.stack([np.eye(4, dtype=np.float32) if mode == "init" else fr.pose_gt] * 2)
    out_per = per._run([5, 6], np.stack([fr.depth] * 2), prev,
                       np.stack([fr.hand_base] * 2), np.stack([fr.hand_q] * 2), mode)
    out_sh = sh._run([5, 6], fr.depth, prev, fr.hand_base, fr.hand_q, mode)
    for name, a, b in zip(out_sh._fields, out_sh, out_per):
        assert torch.equal(a[0], b[0]), name
    return sh


def test_shared_scene_object0_bitwise_and_step(tiny):
    """Counterpart of test_sweep_shared_scene_object0_bitwise: the shared
    mode preps the frame once, on object 0's stream, so object 0's init
    result is bitwise the per-scene path's on copies of the frame; then the
    public step with unbatched inputs, and a mixed frame."""
    fr = tiny["frames"][0]
    sh = _shared_scene_object0(tiny, tiny["cfg"])
    st, res = sh.step(sh.init_state(), fr.depth, fr.hand_base, fr.hand_q)
    assert res.poses.shape == (2, 4, 4) and bool(res.reinitialized.all())
    fitness = st.fitness.clone()
    fitness[1] = 0.0
    _, res2 = sh.step(st._replace(fitness=fitness), fr.depth, fr.hand_base, fr.hand_q)
    assert res2.reinitialized.tolist() == [False, True]


def _fused(cfg):
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, fused_gn=True))


@pytest.mark.parametrize("mode", ["init", "track"])
def test_shared_scene_object0_bitwise_fused_gn(tiny, mode):
    """The shared-scene mode under IcpConfig(fused_gn=True): object 0 bitwise
    the per-scene path's on copies of the frame, through K3's plain version
    (the in-scan refine and the explorer pulls)."""
    _shared_scene_object0(tiny, _fused(tiny["cfg"]), mode)


@pytest.mark.parametrize("mode", ["init", "track"])
def test_shared_scene_gn_fn_gets_a_scene_per_object(tiny, mode):
    """In the shared-scene mode every gn_fn call receives O scenes (ICP
    anchors the one frame per object, and `_search` crops an ROI per
    object), so K3 plans each object's sums from its own P particles, as
    the single estimate does; never one scene for all O x P."""
    fr, O = tiny["frames"][0], 2
    sh = LibrarySweep(tiny["tobjs"][:O], tiny["thand"], _fused(tiny["cfg"]),
                      shared_scene=True)
    gn_fn, seen = sh._est.gn_fn, []

    def spy(scene_c, scene_normals, scene_w, posed_c, posed_normals):
        seen.append((tuple(scene_c.shape), tuple(scene_normals.shape),
                     tuple(scene_w.shape), tuple(posed_c.shape)))
        return gn_fn(scene_c, scene_normals, scene_w, posed_c, posed_normals)

    for attr in ("maxd2", "min_cos", "tau2"):
        setattr(spy, attr, getattr(gn_fn, attr))
    sh._est.gn_fn = spy
    prev = np.stack([np.eye(4, dtype=np.float32) if mode == "init" else fr.pose_gt] * O)
    sh._run([5, 6], fr.depth, prev, fr.hand_base, fr.hand_q, mode)
    assert seen
    for scene, normals, w, posed in seen:
        assert scene[0] == normals[0] == w[0] == posed[0] == O, seen


def test_frame_seeds_and_stacked_draws():
    """A sweep's key advances as a Tracker's, its per-object seeds differ,
    and a Stack serves object o's draws from source o alone."""
    key, k_t, k_i = frame_seeds(7, 3)
    assert key == _split(7)[0] and len(set(k_t + k_i)) == 6
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    draws = rng.normal(rng.Stack(gens), (4, 3))
    assert draws.shape == (2, 4, 3)
    alone = torch.randn((4, 3), generator=torch.Generator().manual_seed(2))
    assert torch.equal(draws[1], alone)
    assert rng.uniform(rng.Stack(gens), (3,)).shape == (2, 3)
    assert rng.permutation(rng.Stack(gens), 5).shape == (2, 5)
    injected = rng.Stack([rng.Draws(np.zeros((2,))), rng.Draws(np.ones((2,)))])
    assert rng.normal(injected, (2,)).tolist() == [[0.0, 0.0], [1.0, 1.0]]
    with pytest.raises(ValueError, match="at least one"):
        rng.Stack([])


# -- (c) against the JAX package's LibrarySweep --------------------------------

@pytest.fixture(scope="module")
def jax_runs(tiny):
    """The JAX sweep's side of the comparisons, run once: three steps of the
    two-box library under a motion prior (init program, track program), one
    forced mixed frame (both), and the H = 2 library (its init and track
    programs): five compiled sweep variants in all."""
    cfg, hand, fr = tiny["cfg"], tiny["hand"], tiny["frames"][0]
    objs = [JaxObjectModel(jmeshio.make_test_object("box"), model_points=256,
                           render_points=512, seed=i) for i in range(2)]
    depths = jnp.tile(jnp.asarray(fr.depth)[None], (2, 1, 1))
    hbs = jnp.tile(jnp.asarray(fr.hand_base)[None], (2, 1, 1))
    hqs = jnp.tile(jnp.asarray(fr.hand_q)[None], (2, 1))
    out = dict(objs=objs)
    sweep = JaxLibrarySweep(objs, hand, _cfg(cfg, motion_prior=0.8))
    st, steps = sweep.init_state(), []
    for _ in range(3):
        st, res = sweep.step(st, depths, hbs, hqs)
        steps.append((np.asarray(res.poses), np.asarray(res.reinitialized),
                      np.asarray(st.vel_ok)))
    out["steps"] = steps
    st1 = st._replace(fitness=st.fitness.at[1].set(0.0))
    st2, res2 = sweep.step(st1, depths, hbs, hqs)
    out["mixed"] = np.asarray(res2.reinitialized).tolist()
    out["mixed_vel_ok"] = np.asarray(st2.vel_ok).tolist()
    sweep2 = JaxLibrarySweep(objs, hand, _cfg(cfg, n_hypotheses=2))
    st = sweep2.init_state()
    st, _ = sweep2.step(st, depths, hbs, hqs)
    st, res = sweep2.step(st, depths, hbs, hqs)
    out["hyp"] = (np.asarray(res.poses), np.asarray(res.hyp_poses),
                  np.asarray(res.hyp_fitness))
    out["state"] = (sweep2, st)
    return out


@pytest.fixture(scope="module")
def box_library(tiny, jax_runs):
    """The port's two-box library on the JAX objects' arrays, and its inputs."""
    fr = tiny["frames"][0]
    objs = [_port_object(o) for o in jax_runs["objs"]]
    return objs, (np.stack([fr.depth] * 2), np.stack([fr.hand_base] * 2),
                  np.stack([fr.hand_q] * 2))


def test_steps_match_reference(tiny, jax_runs, box_library):
    """Three steps under motion_prior = 0.8: the same shapes, masks and
    vel_ok bookkeeping as the JAX sweep (the velocity engages on the third
    step, after two tracked frames), and mean dense ADD-S of the tracked
    steps within max(reference + 3 mm, 5 mm)."""
    objs, inputs = box_library
    fr, dense = tiny["frames"][0], tiny["dense"][0]
    sweep = LibrarySweep(objs, tiny["thand"], _cfg(tiny["cfg"], motion_prior=0.8))
    st = sweep.init_state()
    assert isinstance(st, SweepState) and st.frame_idx == 0
    ref_adds, adds = [], []
    for i, (ref_poses, ref_reinit, ref_vel) in enumerate(jax_runs["steps"]):
        st, res = sweep.step(st, *inputs)
        assert isinstance(res, SweepResult) and res.hyp_poses is None
        assert tuple(res.poses.shape) == ref_poses.shape == (2, 4, 4)
        assert res.fitness.shape == res.coverage.shape == (2,)
        assert bool(torch.isfinite(res.poses).all())
        assert res.reinitialized.tolist() == ref_reinit.tolist() == [i == 0] * 2
        assert st.vel_ok.tolist() == ref_vel.tolist() == [i == 2] * 2
        assert st.frame_idx == i + 1 and bool(st.initialized.all())
        if i > 0:
            ref_adds += _adds_mm(ref_poses, [fr] * 2, [dense] * 2)
            adds += _adds_mm(res.poses.numpy(), [fr] * 2, [dense] * 2)
    print(f"ADD-S mm: reference {np.round(ref_adds, 2)}, port {np.round(adds, 2)}")
    assert np.mean(adds) <= max(np.mean(ref_adds) + 3.0, 5.0), (ref_adds, adds)


def test_mixed_frames_and_coverage_watchdog_match_reference(tiny, jax_runs, box_library):
    """The forced states of test_sweep_mixed_reinit_and_coverage_watchdog:
    a fitness collapse on object 1 re-initializes it alone ([False, True],
    as the JAX sweep answers), a coverage collapse at high fitness on
    object 0 that one alone ([True, False]); the merged state keeps a
    velocity only for the object that went on tracking."""
    objs, inputs = box_library
    sweep = LibrarySweep(objs, tiny["thand"], _cfg(tiny["cfg"], motion_prior=0.8))
    st = sweep.init_state()
    for _ in range(2):
        st, res = sweep.step(st, *inputs)
    fitness = st.fitness.clone()
    fitness[1] = 0.0
    st2, res2 = sweep.step(st._replace(fitness=fitness), *inputs)
    assert res2.reinitialized.tolist() == jax_runs["mixed"] == [False, True]
    assert st2.vel_ok.tolist() == [True, False]
    assert st2.pose_tracked.tolist() == [True, False]
    assert torch.equal(st2.prev_poses, st.poses)
    coverage = st2.coverage.clone()
    coverage[0] = 0.001
    _, res3 = sweep.step(st2._replace(fitness=torch.ones_like(st2.fitness),
                                      coverage=coverage), *inputs)
    assert res3.reinitialized.tolist() == [True, False]


def test_hypothesis_slots_match_reference(tiny, jax_runs, box_library):
    """H = 2: the slots persist across frames with the reference's shapes,
    slot 0 is the committed pose, an empty slot carries -inf, and the
    tracked poses stay within max(reference + 3 mm, 5 mm)."""
    objs, inputs = box_library
    fr, dense = tiny["frames"][0], tiny["dense"][0]
    sweep = LibrarySweep(objs, tiny["thand"], _cfg(tiny["cfg"], n_hypotheses=2))
    st = sweep.init_state()
    assert st.hyp_poses.shape == (2, 2, 4, 4) and bool(torch.isinf(st.hyp_fitness).all())
    st, res = sweep.step(st, *inputs)
    st, res = sweep.step(st, *inputs)
    ref_poses, ref_hyp, ref_hf = jax_runs["hyp"]
    assert tuple(res.hyp_poses.shape) == ref_hyp.shape == (2, 2, 4, 4)
    assert tuple(res.hyp_fitness.shape) == ref_hf.shape == (2, 2)
    assert torch.equal(res.hyp_poses[:, 0], res.poses)
    assert torch.equal(res.hyp_fitness[:, 0], res.fitness)
    late = res.hyp_fitness[:, 1]
    assert bool((torch.isfinite(late) | (late == -float("inf"))).all())
    assert torch.equal(st.hyp_poses, res.hyp_poses)
    adds = _adds_mm(res.poses.numpy(), [fr] * 2, [dense] * 2)
    ref_adds = _adds_mm(ref_poses, [fr] * 2, [dense] * 2)
    assert np.mean(adds) <= max(np.mean(ref_adds) + 3.0, 5.0), (ref_adds, adds)


# -- (d) errors, checkpoints, the command line ---------------------------------

def test_constructor_and_step_errors(tiny):
    cfg, thand, tobjs = tiny["cfg"], tiny["thand"], tiny["tobjs"]
    other = convert.object_from_numpy(
        **{f: getattr(tobjs[0], f).numpy()[:128] for f in ("model_pts", "model_normals")},
        **{f: getattr(tobjs[0], f).numpy() for f in (
            "render_pts", "render_normals", "render_w", "symmetries")},
        diameter=tobjs[0].diameter, device="cpu")
    with pytest.raises(ValueError, match="share"):
        LibrarySweep([tobjs[0], other], thand, cfg)
    with pytest.raises(ValueError, match="at least one object"):
        LibrarySweep([], thand, cfg)
    with pytest.raises(ValueError, match="hypotheses need at least"):
        LibrarySweep(tobjs, thand, _cfg(cfg, n_hypotheses=9))
    with pytest.raises(ValueError, match="needs a mesh with that axis"):
        LibrarySweep(tobjs, thand, cfg, particle_axis="p")
    with pytest.raises(ValueError, match="shared_scene composes"):
        LibrarySweep(tobjs, thand, cfg, particle_axis="p", shared_scene=True)
    sh = LibrarySweep(tobjs[:1], thand, cfg, shared_scene=True)
    with pytest.raises(ValueError, match="ONE frame"):
        sh.step(sh.init_state(), np.zeros((1, 48, 64), np.float32))
    per = LibrarySweep(tobjs[:1], thand, cfg)
    with pytest.raises(ValueError, match="per-scene"):
        per.step(per.init_state(), np.zeros((48, 64), np.float32))
    with pytest.raises(ValueError, match="fix CameraIntrinsics"):
        per.step(per.init_state(), np.zeros((1, 24, 32), np.float32))
    with pytest.raises(ValueError, match="unknown mode"):
        per._run([0], np.zeros((1, 48, 64), np.float32), np.eye(4)[None],
                 np.eye(4)[None], np.zeros((1, 2)), "other")


def test_library_defaults_to_the_card():
    """The models a sweep is built from default to device "cuda": without a
    card that raises instead of quietly using the CPU."""
    from icra20_hand_object_pose_tpu_torch.models import ObjectModel

    if torch.cuda.is_available():
        pytest.skip("a card is present: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        ObjectModel(meshio.make_test_object("box"), model_points=64, render_points=64)


def test_symmetry_groups_are_identity_padded(tiny):
    """A library of a box (a symmetry group) and a sphere (identity alone)
    pads the smaller group with identities, which never win the snap."""
    sweep = LibrarySweep(tiny["tobjs"], tiny["thand"], tiny["cfg"])
    sym = sweep._obj_tensors[5]
    sizes = [o.symmetries.shape[0] for o in tiny["tobjs"]]
    assert sym.shape == (3, max(sizes), 4, 4) and min(sizes) < max(sizes)
    small = int(np.argmin(sizes))
    assert torch.equal(sym[small, sizes[small]:],
                       torch.eye(4).expand(max(sizes) - sizes[small], 4, 4))


def test_save_load_resumes_bitwise(tiny, box_library, tmp_path):
    """save_state after a step, load_state into a second sweep: the next
    step is bitwise the uninterrupted one; the file holds the reference's
    field names."""
    objs, inputs = box_library
    cfg = _cfg(tiny["cfg"], n_hypotheses=2)
    sweep = LibrarySweep(objs, tiny["thand"], cfg)
    st, _ = sweep.step(sweep.init_state(seed=3), *inputs)
    path = str(tmp_path / "sweep_ckpt")
    sweep.save_state(st, path)
    z = np.load(path + ".npz")
    assert set(z.files) == {"poses", "fitness", "initialized", "key", "frame_idx",
                            "coverage", "hyp_poses", "hyp_fitness", "prev_poses",
                            "vel_ok", "pose_tracked"}
    other = LibrarySweep(objs, tiny["thand"], cfg)
    st2 = other.load_state(path)
    assert st2.key == st.key and st2.frame_idx == 1
    for a, b in zip(st, st2):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    _, res_a = sweep.step(st, *inputs)
    _, res_b = other.step(st2, *inputs)
    # a per-scene sweep names no candidate
    assert res_a.named is None and res_a.score is None
    assert all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(res_a, res_b))


def test_reference_state_loads(tiny, jax_runs, box_library, tmp_path):
    """A JAX-package save_state file loads into the port (every field but
    the threefry key, which is re-derived as a sweep of this package would
    hold it after as many frames), and so does the state's NamedTuple."""
    objs, inputs = box_library
    jsweep, jst = jax_runs["state"]
    path = str(tmp_path / "jax_sweep.npz")
    jsweep.save_state(jst, path)
    sweep = LibrarySweep(objs, tiny["thand"], _cfg(tiny["cfg"], n_hypotheses=2))
    st = sweep.load_state(path, seed=4)
    assert st.frame_idx == 2 and st.key == convert.reseeded_key(4, 2)
    want = sweep.init_state(seed=4)
    for _ in range(2):
        want = want._replace(key=frame_seeds(want.key, 2)[0])
    assert st.key == want.key
    np.testing.assert_array_equal(st.poses.numpy(), np.asarray(jst.poses))
    np.testing.assert_array_equal(st.hyp_fitness.numpy(), np.asarray(jst.hyp_fitness))
    assert st.vel_ok.dtype == torch.bool and st.pose_tracked.tolist() == [True, True]
    fields = {k: (None if v is None or k == "key" else np.asarray(v))
              for k, v in jst._asdict().items()}
    st_b = convert.sweep_state_from_numpy(fields, seed=4, device="cpu")
    for a, b in zip(st, st_b):
        assert (torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
    _, res = sweep.step(st, *inputs)
    assert res.reinitialized.tolist() == [False, False]


def test_cli_sweep(tiny, tmp_path):
    """`cli sweep` on two tiny recorded sequences: per-object pose files,
    one metrics record per frame, the reference's printed layout."""
    import yaml

    cfg_path = str(tmp_path / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "scene_points": 256, "render_size": 48,
            "pso": {"particles": 16, "iters": 2, "icp_iters_inner": 2,
                    "finish_iters": 2, "finish_particles": 16},
            "tracker": {"reinit_particles": 16, "reinit_prescreen": 64},
            "hand": {"config_samples": 2}}, f)
    cam = tiny["cfg"].camera
    argv = ["sweep", "--config", cfg_path, "--out", str(tmp_path / "out"),
            "--device", "cpu", "--shard"]
    for shape in ("box", "cylinder"):
        mesh = meshio.make_test_object(shape)
        frames = generate_sequence(
            mesh, tiny["thand"], SyntheticSequenceConfig(n_frames=2, camera=cam),
            device="cpu")
        save_sequence(frames, cam, str(tmp_path / f"seq_{shape}"))
        meshio.save_obj(mesh, str(tmp_path / f"{shape}.obj"))
        argv += ["--data", str(tmp_path / f"seq_{shape}"),
                 "--object", str(tmp_path / f"{shape}.obj")]
    assert cli.main(argv) == 0
    recs = [json.loads(l) for l in open(tmp_path / "out" / "metrics.jsonl")]
    assert [r["frame"] for r in recs] == [0, 1]
    assert recs[0]["reinitialized"] == [True, True]
    assert len(recs[1]["fitness"]) == len(recs[1]["add_s"]) == 2
    for o in range(2):
        for i in range(2):
            pose = np.loadtxt(tmp_path / "out" / f"obj{o:02d}_poses" / f"{i:06d}.txt")
            assert pose.shape == (4, 4) and np.isfinite(pose).all()
    assert cli.main(argv[:-2]) == 2          # a sequence without its object
