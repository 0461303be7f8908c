"""The port's command line (`demo` -> `eval` -> `track` at 64x48 on the CPU),
its copies of the parity harness and the overlay writer, and the
recorded-sequence slice as a whole: a 3-frame tiny sequence is written to
disk, read back and tracked from the ground truth by both packages; they
draw different random numbers, so the pose streams are compared by mean
dense ADD-S, the port's within max(reference + 3 mm, 5 mm)."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from icra20_hand_object_pose_tpu import visualize as jvisualize
from icra20_hand_object_pose_tpu.datasets import sequence as jsequence
from icra20_hand_object_pose_tpu.models import (
    Estimator as JaxEstimator, ObjectModel as JaxObjectModel,
    Tracker as JaxTracker, make_t42_hand as jax_t42,
)
from icra20_hand_object_pose_tpu_torch import cli, evaluation, parity, visualize
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.datasets.sequence import (
    RecordedSequence, save_sequence,
)
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.utils import meshio, pngio
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny_cfg_yaml(tmp_path_factory):
    cfg = {
        "scene_points": 256,
        "render_size": 48,
        "pso": {"particles": 16, "iters": 2, "icp_iters_inner": 2,
                "finish_iters": 2, "finish_particles": 16},
        "tracker": {"reinit_particles": 16, "reinit_prescreen": 64},
        "hand": {"config_samples": 2},
    }
    p = str(tmp_path_factory.mktemp("cfg") / "cfg.yaml")
    with open(p, "w") as f:
        yaml.safe_dump(cfg, f)
    return p


def test_demo_eval_track_roundtrip(tmp_path, tiny_cfg_yaml, capsys):
    out = str(tmp_path / "out")
    rc = cli.main([
        "demo", "--frames", "2", "--width", "64", "--height", "48",
        "--config", tiny_cfg_yaml, "--out", out, "--overlays", "--device", "cpu",
    ])
    assert rc == 0
    for rel in ("metrics.jsonl", "summary.json", "poses/000001.txt",
                "overlays/overlay_000001.png", "sequence/cam_K.txt",
                "sequence/depth/000001.png", "sequence/pose_gt/000001.txt"):
        assert os.path.exists(os.path.join(out, rel)), rel
    recs = [json.loads(l) for l in open(os.path.join(out, "metrics.jsonl"))]
    assert len(recs) == 2 and "add_s" in recs[0] and "trans_err" in recs[1]
    assert recs[0]["reinitialized"] and not recs[1]["reinitialized"]
    assert np.asarray(recs[1]["pose"]).shape == (4, 4)
    np.testing.assert_allclose(np.loadtxt(os.path.join(out, "poses", "000001.txt")),
                               np.asarray(recs[1]["pose"]), rtol=1e-6, atol=1e-8)
    assert pngio.read_png_rgb(
        os.path.join(out, "overlays", "overlay_000001.png")).shape == (48, 64, 3)

    # eval on the produced artifacts, with a parity report of the pose
    # files against the jsonl dump of the same run
    mesh_path = str(tmp_path / "box.obj")
    meshio.save_obj(meshio.make_test_object("box"), mesh_path)
    capsys.readouterr()
    rc = cli.main([
        "eval", "--poses", os.path.join(out, "metrics.jsonl"),
        "--data", os.path.join(out, "sequence"), "--object", mesh_path,
        "--ref-poses", os.path.join(out, "poses"), "--device", "cpu",
    ])
    assert rc == 0
    printed = capsys.readouterr().out
    assert "2/2 identical" in printed
    summary = json.loads(printed.strip().splitlines()[-1])
    with open(os.path.join(out, "summary.json")) as f:
        assert summary["n_frames"] == json.load(f)["n_frames"] == 2

    # track the saved sequence directly, under the profiler
    out2 = str(tmp_path / "out2")
    rc = cli.main([
        "--profile", str(tmp_path / "prof"),
        "track", "--data", os.path.join(out, "sequence"),
        "--object", mesh_path, "--config", tiny_cfg_yaml, "--out", out2,
        "--device", "cpu",
    ])
    assert rc == 0
    assert os.path.exists(os.path.join(out2, "summary.json"))
    assert not os.path.exists(os.path.join(out2, "overlays"))
    with open(str(tmp_path / "prof" / "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_eval_missing_poses_is_clean_error(tmp_path, capsys):
    mesh_path = str(tmp_path / "box.obj")
    meshio.save_obj(meshio.make_test_object("box"), mesh_path)
    rc = cli.main([
        "eval", "--poses", str(tmp_path / "nonexistent.jsonl"),
        "--data", str(tmp_path / "noseq"), "--object", mesh_path,
        "--device", "cpu",
    ])
    assert rc == 2
    assert "not found" in capsys.readouterr().err


def test_module_entry_point_and_unported_subcommands():
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *a: subprocess.run(
        [sys.executable, "-m", "icra20_hand_object_pose_tpu_torch.cli", *a],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    res = run("demo", "--help")
    assert res.returncode == 0 and "--device" in res.stdout
    res = run("sweep", "--help")
    assert res.returncode == 0 and "--shard" in res.stdout and "--device" in res.stdout
    res = run("bench", "--help")
    assert res.returncode == 0 and "--device" in res.stdout


# -- parity.py (the cases of tests/test_parity.py on the port's copy) ---------

def _traj(n=5, seed=0):
    rng = np.random.default_rng(seed)
    poses = []
    T = np.eye(4)
    T[:3, 3] = [0, 0, 0.5]
    for _ in range(n):
        w = rng.normal(0, 0.02, 3)
        th = np.linalg.norm(w)
        k = w / max(th, 1e-12)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
        T = T.copy()
        T[:3, :3] = T[:3, :3] @ R
        T[:3, 3] += rng.normal(0, 0.003, 3)
        poses.append(T.copy())
    return poses


def test_parity_identical_trajectories_report_identical():
    est = _traj()
    rep = parity.compare_pose_sequences(est, [p.copy() for p in est])
    assert rep.identical and rep.n_identical == len(est)
    assert rep.rot_deg_max < 1e-4 and rep.trans_max < 1e-9


def test_parity_deviation_detected_and_quantified():
    est = _traj()
    ref = [p.copy() for p in est]
    ref[2][:3, 3] += [0.002, 0, 0]       # 2 mm off on one frame
    pts, _ = meshio.make_test_object("box").sample_surface(512, seed=1)
    rep = parity.compare_pose_sequences(est, ref, pts)
    assert not rep.identical
    assert rep.n_identical == len(est) - 1
    assert rep.trans_max == pytest.approx(0.002, rel=1e-6)
    assert rep.add_s_max == pytest.approx(0.002, rel=0.2)
    assert "identical" in str(rep)


def test_parity_length_mismatch_raises():
    with pytest.raises(ValueError, match="estimated vs"):
        parity.compare_pose_sequences(_traj(4), _traj(5))


def test_parity_load_pose_dump_formats(tmp_path):
    poses = _traj(3)
    d = tmp_path / "dumpdir"
    d.mkdir()
    for i, p in enumerate(poses):
        np.savetxt(d / f"{i:06d}.txt", p)
    jl = tmp_path / "poses.jsonl"
    with open(jl, "w") as f:
        for p in poses:
            f.write(json.dumps({"pose": p.tolist(), "other": 1}) + "\n")
    st = tmp_path / "stacked.txt"
    np.savetxt(st, np.concatenate(poses))
    npy = tmp_path / "poses.npy"
    np.save(npy, np.stack(poses))
    npz = tmp_path / "poses.npz"
    np.savez(npz, poses=np.stack(poses))
    for path in [str(d), str(jl), str(st), str(npy), str(npz)]:
        loaded = parity.load_pose_dump(path)
        assert len(loaded) == 3
        for a, b in zip(loaded, poses):
            np.testing.assert_allclose(a, b, atol=1e-9)
    assert parity.reference_parity(str(d), str(npy)).identical


# -- the slice as a whole, and the overlays -----------------------------------

CAM = CameraIntrinsics(width=64, height=48, fx=57.6, fy=57.6, cx=32.0, cy=24.0)


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A 3-frame sequence made by the port, on disk in the recorded layout."""
    root = str(tmp_path_factory.mktemp("seq") / "sequence")
    mesh = meshio.make_test_object("box")
    hand = make_t42_hand(points_per_link=64, device="cpu")
    frames = generate_sequence(
        mesh, hand, SyntheticSequenceConfig(n_frames=3, camera=CAM), device="cpu")
    save_sequence(frames, CAM, root)
    return root, mesh, hand


def test_sequence_slice_matches_reference(recorded):
    root, mesh, hand = recorded
    seq = RecordedSequence(root)
    jseq = jsequence.RecordedSequence(root, use_native=False)
    cfg = EstimatorConfig(
        camera=seq.camera, scene_points=256, render_size=48,
        pso=PsoConfig(particles=32, iters=3, icp_iters_inner=2),
        tracker=TrackerConfig(reinit_particles=32, reinit_prescreen=64))
    dense, _ = mesh.sample_surface(4096, seed=5)

    def adds_mm(pose, fr):
        return 1000.0 * evaluation.add_s_error(np.asarray(pose), fr.pose_gt, dense)

    tracker = Tracker(Estimator(
        ObjectModel(mesh, model_points=256, render_points=512, device="cpu"),
        hand, cfg), seed=0)
    tracker.state = tracker.state._replace(
        pose=torch.tensor(seq[0].pose_gt), initialized=True, fitness=1.0)
    port = []
    for fr in seq:
        out = tracker.step(fr.depth, fr.hand_base, fr.hand_q)
        assert not out.reinitialized
        port.append(adds_mm(out.pose, fr))

    jtracker = JaxTracker(JaxEstimator(
        JaxObjectModel(mesh, model_points=256, render_points=512),
        jax_t42(points_per_link=64), cfg))
    jtracker.state = jtracker.state._replace(
        pose=jnp.asarray(jseq[0].pose_gt), initialized=jnp.asarray(True),
        fitness=jnp.asarray(1.0))
    ref = []
    for fr in jseq:
        out = jtracker.step(jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
                            jnp.asarray(fr.hand_q))
        ref.append(adds_mm(out.pose, fr))
    print(f"ADD-S mm: reference {np.round(ref, 2)}, port {np.round(port, 2)}")
    assert np.mean(port) <= max(np.mean(ref) + 3.0, 5.0), (ref, port)
    # the object moved 8 mm over the sequence: the tracker followed it
    assert max(port) < 0.5 * 1000.0 * np.linalg.norm(
        seq[2].pose_gt[:3, 3] - seq[0].pose_gt[:3, 3]) + 5.0


@pytest.mark.parametrize("with_rgb", [False, True])
def test_overlay_matches_reference(recorded, with_rgb, tmp_path):
    root, mesh, hand = recorded
    fr = RecordedSequence(root)[1]
    obj = ObjectModel(mesh, model_points=256, render_points=512, device="cpu")
    jobj = JaxObjectModel(mesh, model_points=256, render_points=512)
    pose = fr.pose_gt.copy()
    pose[0, 3] += 0.004                       # some agreement, some not
    kw = dict(hand_base=fr.hand_base, hand_q=fr.hand_q,
              rgb=fr.rgb if with_rgb else None)
    ref = jvisualize.render_overlay(fr.depth, pose, jobj, CAM,
                                    hand=jax_t42(points_per_link=64), **kw)
    out = visualize.render_overlay(fr.depth, pose, obj, CAM, hand=hand, **kw)
    assert out.shape == (48, 64, 3) and out.dtype == np.uint8
    # the same splats and numpy compositing: a pixel differs only where a
    # sample rounds into the neighbouring pixel
    assert np.mean(np.any(out != ref, axis=-1)) <= 0.01
    assert len(np.unique(out.reshape(-1, 3), axis=0)) > 4
    np.testing.assert_array_equal(visualize.depth_to_gray(fr.depth),
                                  jvisualize.depth_to_gray(fr.depth))
    paths = visualize.save_sequence_overlays(
        str(tmp_path / "ov"), [fr, fr], [pose, fr.pose_gt], obj, CAM, hand=hand)
    assert [os.path.basename(p) for p in paths] == ["overlay_000000.png",
                                                    "overlay_000001.png"]
    np.testing.assert_array_equal(
        pngio.read_png_rgb(paths[0]),
        visualize.render_overlay(fr.depth, pose, obj, CAM, hand=hand,
                                 hand_base=fr.hand_base, hand_q=fr.hand_q))
