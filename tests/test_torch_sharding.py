"""The port's device mesh on the CPU: two gloo ranks (tests/
torch_sharding_ranks.py), started once for the module, run every sharded
case at tests/test_sharding.py's tiny size; the tests read their results.

- the particle axis (`Estimator(mesh=make_mesh(2, "p"))`, 8 + 8 particles):
  pose, fitness and hypothesis slots bitwise equal on both ranks, ADD-S
  < 8 mm (the reference's test_particle_sharded_matches_quality), the
  divisibility and per-shard hypothesis errors;
- the object axis (`LibrarySweep(mesh=make_mesh(2, "obj"))`, 2 objects a
  rank): an init step, a track step and a forced mixed frame bitwise the
  one-process sweep; the shared-scene sweep bitwise the one-process one; a
  (1, 2) mesh with each swarm over "p" finite; the state one saved resumes
  bitwise in a one-process sweep; `cli sweep --shard` writes the
  one-process run's files;
- against the JAX package: the selection over the gathered candidates
  against `pso.continuity_select` on the concatenated set, and the 2-rank
  frame's ADD-S against `Estimator(mesh=make_mesh(2, "p"))` (the one sharded
  JAX program these tests compile), within max(reference + 3 mm, 5 mm).
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.models import Estimator as JaxEstimator
from icra20_hand_object_pose_tpu.models import ObjectModel as JaxObjectModel
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.ops import pso as jax_pso
from icra20_hand_object_pose_tpu.parallel import make_mesh as jax_make_mesh
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio
from icra20_hand_object_pose_tpu_torch import cli, evaluation
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.datasets.sequence import save_sequence
from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep, make_mesh
from icra20_hand_object_pose_tpu_torch.parallel import mesh as mesh_mod
from icra20_hand_object_pose_tpu_torch.utils import meshio, rng, se3
from torch_sharding_ranks import (
    SHAPES, models, run_ranks, sweep_steps, tiny_config,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inputs, both ranks' results, and the one-process models."""
    import yaml

    tmp = tmp_path_factory.mktemp("sharding")
    cfg = tiny_config()
    hand, objs = models()
    cam = cfg.camera
    frames = [generate_sequence(
        m, hand, SyntheticSequenceConfig(n_frames=1, camera=cam, noise_sigma=0.0,
                                         dropout=0.0), device="cpu")[0]
        for m in (o.mesh for o in objs)]
    fr = {k: np.stack([getattr(f, k) for f in frames])
          for k in ("depth", "hand_base", "hand_q", "pose_gt")}
    offset = se3.compose(se3.se3_exp(torch.tensor([0.05, 0.0, 0.0, 0.004, 0.0, 0.0])),
                         torch.as_tensor(fr["pose_gt"][0])).numpy()
    # `cli sweep` on two recorded sequences of 2 frames
    cfg_path = str(tmp / "cfg.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump({
            "scene_points": 256, "render_size": 48,
            "pso": {"particles": 16, "iters": 2, "icp_iters_inner": 2,
                    "finish_iters": 2, "finish_particles": 16},
            "tracker": {"reinit_particles": 16, "reinit_prescreen": 64},
            "hand": {"config_samples": 2}}, f)
    argv = ["sweep", "--config", cfg_path, "--device", "cpu"]
    for s, o in zip(SHAPES[:2], objs):
        seq = generate_sequence(o.mesh, hand, SyntheticSequenceConfig(n_frames=2, camera=cam),
                                device="cpu")
        save_sequence(seq, cam, str(tmp / f"seq_{s}"))
        meshio.save_obj(o.mesh, str(tmp / f"{s}.obj"))
        argv += ["--data", str(tmp / f"seq_{s}"), "--object", str(tmp / f"{s}.obj")]
    data = dict(frames=fr, offset_pose=offset, state_path=str(tmp / "state.npz"),
                tracker_path=str(tmp / "tracker.npz"),
                cli_argv=argv + ["--out", str(tmp / "cli_shard")])
    ranks = run_ranks(data, world=2, timeout=300.0)
    return dict(data=data, ranks=ranks, cfg=cfg, hand=hand, objs=objs, tmp=tmp,
                cli_argv=argv + ["--out", str(tmp / "cli_one")])


def _equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.array_equal(a[k], b[k]), k


# -- the particle axis ------------------------------------------------------------

@pytest.mark.parametrize("case", ["frame", "frame_h2"])
def test_sharded_outputs_bitwise_replicated(world, case):
    """Counterpart of test_sharded_outputs_bitwise_replicated: the whole
    split frame (scan, polish, finisher, hypothesis extraction) returns the
    same bits on every rank, with one prior and with two."""
    r0, r1 = (r[case] for r in world["ranks"])
    _equal(r0, r1)
    assert np.isfinite(r0["pose"]).all() and np.isfinite(r0["fitness"])
    if case == "frame_h2":
        assert r0["hyp_poses"].shape == (2, 4, 4) and np.isfinite(r0["hyp_fitness"][0])


def test_particle_sharded_matches_quality(world):
    """Counterpart of test_particle_sharded_matches_quality: a split swarm
    tracks the frame to ADD-S < 8 mm on the model cloud."""
    out, fr = world["ranks"][0]["frame"], world["data"]["frames"]
    adds = evaluation.add_s_error(out["pose"], fr["pose_gt"][0],
                                  world["objs"][0].model_pts.numpy())
    assert adds < 0.008, f"ADD-S {adds * 1000:.2f} mm"


def test_tracker_over_sharded_estimator(world):
    """Tracker.step over the split estimator: the same pose on both ranks;
    rank 0's checkpoint loads into a one-process Tracker with that pose."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator, Tracker

    poses = [r["tracker"] for r in world["ranks"]]
    assert np.array_equal(poses[0], poses[1]) and np.isfinite(poses[0]).all()
    one = Tracker(Estimator(world["objs"][0], world["hand"], world["cfg"]), seed=2)
    one.load(world["data"]["tracker_path"])
    assert one.state.frame_idx == 1 and np.array_equal(one.state.pose.numpy(), poses[0])


def test_sharding_errors(world):
    """The reference's errors, raised on the ranks: particles not divisible
    by the mesh, too few particles per shard for the hypotheses, objects
    not divisible by the object axis, the sweep's per-shard hypotheses."""
    errs = world["ranks"][0]["errors"]
    assert errs == world["ranks"][1]["errors"]
    assert "n_particles=13 not divisible by mesh size 2" in errs[0]
    assert "particles per shard; got 3" in errs[1] and "over 2 shards" in errs[1]
    assert "3 objects not divisible by mesh axis obj=2" in errs[2]
    assert "per shard" in errs[3] and "over 2 particle shards" in errs[3]


def test_mesh_errors(world):
    """make_mesh needs a process group of its size; particle_axis needs a
    mesh with that axis, and does not compose with shared_scene."""
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(2)
    with pytest.raises(ValueError, match="needs a mesh"):
        LibrarySweep(world["objs"], world["hand"], world["cfg"], particle_axis="p")
    with pytest.raises(ValueError, match="shared_scene composes"):
        LibrarySweep(world["objs"], world["hand"], world["cfg"], particle_axis="p",
                     shared_scene=True)


def test_fold_refuses_shared_draws():
    """A shard's search draws from its own stream: generators fold to one
    seed per shard, and injected draws feed shard 0 only (served alike to
    every shard, they would make the shards' swarms copies)."""
    g = torch.Generator().manual_seed(7)
    seeds = [rng.fold(g, i).initial_seed() for i in range(3)]
    assert len(set(seeds)) == 3 and seeds[0] == rng.fold(g, 0).initial_seed()
    d = rng.Draws(np.zeros((2,)))
    assert rng.fold(d, 0) is d
    for src in (d, rng.Stack([d, d])):
        with pytest.raises(ValueError, match="shard 1"):
            rng.fold(src, 1)


def test_mesh_module_is_a_leaf():
    """ops/pso.py and models/estimator.py reach the mesh's gather through
    parallel/mesh.py, which imports no module of the package: loading
    them loads no part of the sweep."""
    code = ("import sys\n"
            "import icra20_hand_object_pose_tpu_torch.ops.pso\n"
            "import icra20_hand_object_pose_tpu_torch.models.estimator\n"
            "assert 'icra20_hand_object_pose_tpu_torch.parallel.sharding' not in "
            "sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
    with open(mesh_mod.__file__) as f:
        assert "from ." not in f.read()


# -- the object axis ----------------------------------------------------------------

@pytest.fixture(scope="module")
def one_process(world):
    """The one-process sweep's steps on the ranks' inputs."""
    fr = world["data"]["frames"]
    sweep = LibrarySweep(world["objs"], world["hand"], world["cfg"])
    steps, _ = sweep_steps(sweep, (fr["depth"], fr["hand_base"], fr["hand_q"]), forced=1)
    return sweep, steps


@pytest.mark.parametrize("step", ["init", "track", "mixed"])
def test_object_sharded_sweep_matches_one_process(world, one_process, step):
    """2 objects a rank: every field of the init step, the track step and a
    mixed frame (object 1 re-initialises on rank 0 beside object 0's track;
    rank 1 tracks alone) bitwise the one-process sweep's, on both ranks."""
    i = ["init", "track", "mixed"].index(step)
    ref = one_process[1][i]
    for r in world["ranks"]:
        _equal(r["sweep"][i], ref)
    expect = {"init": [True] * 4, "track": [False] * 4,
              "mixed": [False, True, False, False]}[step]
    assert ref["reinitialized"].tolist() == expect


def test_shared_scene_sharded_matches_one_process(world):
    """The shared frame is prepped on every rank on object 0's stream: each
    object's init pose bitwise the one-process shared-scene sweep's."""
    fr = world["data"]["frames"]
    shared = LibrarySweep(world["objs"], world["hand"], world["cfg"], shared_scene=True)
    _, res = shared.step(shared.init_state(), fr["depth"][0], fr["hand_base"][0],
                         fr["hand_q"][0])
    for r in world["ranks"]:
        assert np.array_equal(r["shared"], res.poses.numpy())


def test_2d_sweep_finite(world):
    """A (1, 2) mesh: the objects over "obj", each swarm over "p": finite,
    the same on both ranks."""
    r0, r1 = (r["sweep_2d"] for r in world["ranks"])
    for a, b in zip(r0, r1):
        assert np.array_equal(a, b)
    assert all(np.isfinite(a).all() for a in r0) and r0[0].shape == (4, 4, 4)


def test_sharded_state_resumes_in_one_process(world, one_process):
    """save_state on the mesh writes the one-process file: loaded into the
    one-process sweep, the forced mixed frame repeats bitwise."""
    sweep, steps = one_process
    fr = world["data"]["frames"]
    st = sweep.load_state(world["data"]["state_path"])
    assert st.frame_idx == 2
    fitness = st.fitness.clone()
    fitness[1] = 0.0
    st, res = sweep.step(st._replace(fitness=fitness), fr["depth"], fr["hand_base"],
                         fr["hand_q"])
    for k, v in res._asdict().items():
        if v is not None:
            assert np.array_equal(v.numpy(), steps[2][k]), k


def test_cli_sweep_shard_writes_the_one_process_files(world):
    """`cli sweep --shard` in a 2-rank process group: rank 0 writes the pose
    files and metrics of the one-process run (bitwise, but the times)."""
    assert [r["cli"] for r in world["ranks"]] == [0, 0]
    assert cli.main(world["cli_argv"] + ["--shard"]) == 0   # a lone process
    one, shard = world["tmp"] / "cli_one", world["tmp"] / "cli_shard"
    recs = [[json.loads(l) for l in open(d / "metrics.jsonl")] for d in (one, shard)]
    for a, b in zip(*recs):
        a.pop("ms"), b.pop("ms")
        assert a == b
    names = sorted(os.listdir(one / "obj01_poses"))
    assert names == sorted(os.listdir(shard / "obj01_poses")) and len(names) == 2
    for o in range(2):
        for n in names:
            d = f"obj{o:02d}_poses"
            assert (one / d / n).read_text() == (shard / d / n).read_text()


def test_cli_shard_refuses_several_cards_without_torchrun(monkeypatch, capsys):
    """A lone process asked to shard over several cards never runs on one
    of them quietly: it returns 2 and says how to launch it."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert cli.main(["sweep", "--shard", "--device", "cuda", "--data", "seq",
                     "--object", "obj.obj"]) == 2
    assert "torchrun --nproc-per-node 4" in capsys.readouterr().err


# -- against the JAX package ------------------------------------------------------

def test_gathered_selection_matches_reference(world):
    """Each rank's 5 candidates (fitness on a grid of quarters: ties),
    gathered then selected by continuity_select, against the JAX function
    on the concatenated set: the same index, poses within 1e-6."""
    r0, r1 = (r["select"] for r in world["ranks"])
    cand = np.concatenate([r0["cand"][0], r1["cand"][0]])
    fit = np.concatenate([r0["fit"][0], r1["fit"][0]])
    prior = world["data"]["frames"]["pose_gt"][0]
    model = world["objs"][0].model_pts.numpy()
    ref = int(jax_pso.continuity_select(jnp.asarray(cand), jnp.asarray(fit),
                                        jnp.asarray(prior), jnp.asarray(model), eps=0.3))
    for r in (r0, r1):
        assert int(r["idx"][0]) == ref
        np.testing.assert_allclose(r["pose"][0], cand[ref], atol=1e-6)


def test_sharded_frame_against_reference(world):
    """The JAX Estimator over a 2-device mesh on the same frame and prior:
    the port's 2-rank ADD-S within max(reference + 3 mm, 5 mm) (dense
    cloud; the two draw different numbers)."""
    cfg_t = world["cfg"]
    from icra20_hand_object_pose_tpu.utils.config import (
        CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
    )

    c = cfg_t.camera
    cfg = EstimatorConfig(
        camera=CameraIntrinsics(width=c.width, height=c.height, fx=c.fx, fy=c.fy,
                                cx=c.cx, cy=c.cy),
        scene_points=256, render_size=48,
        pso=PsoConfig(particles=16, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=64))
    fr = world["data"]["frames"]
    mesh = jmeshio.make_test_object(SHAPES[0])
    est = JaxEstimator(JaxObjectModel(mesh, model_points=256, render_points=512, seed=0),
                       jax_t42(points_per_link=64), cfg, mesh=jax_make_mesh(2, "p"))
    out = est.estimate(*(jnp.asarray(fr[k][0]) for k in ("depth", "pose_gt",
                                                         "hand_base", "hand_q")))
    dense = mesh.sample_surface(4096, seed=5)[0]
    ref = 1000.0 * evaluation.add_s_error(np.asarray(out.pose), fr["pose_gt"][0], dense)
    mine = 1000.0 * evaluation.add_s_error(world["ranks"][0]["frame"]["pose"],
                                           fr["pose_gt"][0], dense)
    assert np.isfinite(ref) and mine <= max(ref + 3.0, 5.0), (ref, mine)
