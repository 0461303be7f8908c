"""The port against the behaviour claim of `tests/test_hand.py` that no
other port test states, at the reference's size, configuration and
thresholds: `test_config_select_recovers_evidence_under_wrong_nominal_q`.
A deliberately wrong nominal hand_q (+0.3 rad) makes the blind union of the
sampled hand masks eat object evidence; observation-driven config selection
(`HandConfig.config_select=3`) must keep at least 5 more scene points and
track at least as well (ADD-S under max(1.5 x the union's, 6 mm)).

The frame, object and hand are the reference test's own (the JAX package's
`render_frame_fast` on the CPU, its ObjectModel and T42 hand), handed to the
port as arrays. Everything the estimator draws, the 16 sampled finger
configurations included, comes from the port's own stream, seeded with the
seed's integer: nothing is injected.

Both assertions depend on the finger samples the estimator draws first: the
evidence assertion on nothing else (the scene prep's point counts), so a
seed passes or fails it by its samples. The port's pass count is therefore
held against the reference's on the same scenes:
`tests/torch_behaviour_reference.json` (`tests/port_gate_parity.py --only
behaviour`) holds the reference's runs of the test's body with the port's
finger samples of each seed injected into the reference's hand (the rest of
its frame on its own key of that number): 9 of seeds 0-15 pass, as 9 of
the port's do. It also holds the reference's runs on its own keys 0-15 (15
pass), whose samples recover the evidence on all 16, where the port's
seeds 0-15 recover it on 10; over 300 seeds each package's own first stage
recovers it on 68% (the reference) and 71% (the port)
(`selection_recovery`).
"""
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.datasets import (
    default_object_pose, hand_base_for_grasp, render_frame_fast,
)
from icra20_hand_object_pose_tpu.models import ObjectModel as JaxObjectModel
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.utils import meshio
from icra20_hand_object_pose_tpu_torch.evaluation import add_s_error
from icra20_hand_object_pose_tpu_torch.models import Estimator
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, HandConfig, PsoConfig,
)

from torch_ref_models import port_hand, port_object

torch.set_num_threads(2)
TEST = "test_config_select_recovers_evidence_under_wrong_nominal_q"
RECORD = os.path.join(os.path.dirname(__file__), "torch_behaviour_reference.json")
# seeds of the pass count (what fits the file's minute on one worker)
SEEDS = 8


def record() -> dict:
    with open(RECORD) as f:
        return json.load(f)[f"test_hand.py::{TEST}"]


def reference_normals(key: int, n_samples: int = 16, n_joints: int = 2) -> np.ndarray:
    """The unit normals [K,J] from which the reference estimator samples its
    finger configurations at jax.random.key(key): its draw from the first
    of the frame key's four splits."""
    k_hand = jax.random.split(jax.random.key(key), 4)[0]
    return np.asarray(jax.random.normal(k_hand, (n_samples, n_joints)))


def fixed_samples(hand, normals: np.ndarray):
    """`hand.sampled_clouds` serving the finger configurations of `normals`
    ([K,J] unit normals, scaled by sigma; sample 0 the nominal, as in the
    package) in place of the port's own draw."""
    def sampled_clouds(gen, base_pose, q_nominal, sigma, n_samples):
        noise = torch.tensor(np.asarray(normals, np.float32)[:n_samples]) * sigma
        noise[0] = 0.0
        return hand.cloud(base_pose, torch.clamp(q_nominal[None] + noise, 0.0, math.pi))

    return sampled_clouds


def logged_samples(hand, log: list):
    """`hand.sampled_clouds` as the package runs it, appending to `log` the
    unit normals [K,J] it draws (the generator's state replayed)."""
    draw = type(hand).sampled_clouds

    def sampled_clouds(gen, base_pose, q_nominal, sigma, n_samples):
        replay = torch.Generator().set_state(gen.get_state())
        log.append(torch.randn((n_samples, hand.n_joints), generator=replay).numpy())
        return draw(hand, gen, base_pose, q_nominal, sigma, n_samples)

    return sampled_clouds


def scene_points(est, sc, gen_seed: int = 0) -> float:
    """The scene cloud's point count after `est`'s scene prep of the test's
    frame on a generator seeded `gen_seed`: the first stage of
    `est.estimate(..., key=gen_seed)`."""
    _, w, *_ = est._scene_prep(torch.Generator().manual_seed(gen_seed),
                               *(est._tensor(sc[k]) for k in ("depth", "hb", "q_wrong")))
    return float(w.sum())


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def make_scene() -> dict:
    """The reference test's frame, models and configuration (config_select
    0, the union; `_cfg` sets the selection)."""
    cam = CameraIntrinsics(width=160, height=120, fx=140.0, fy=140.0,
                           cx=80.0, cy=60.0)
    jhand = jax_t42(points_per_link=128)
    mesh = meshio.make_test_object("box")
    jobj = JaxObjectModel(mesh, model_points=512, render_points=1024)
    pose = default_object_pose()
    hb = hand_base_for_grasp(pose)
    q_true = np.asarray([0.45, 0.45], np.float32)
    q_wrong = q_true + 0.3              # nominal LIES (no encoders)
    depth = np.asarray(render_frame_fast(mesh, pose, jhand, hb, q_true, cam))
    base = EstimatorConfig(
        camera=cam, scene_points=1024, render_size=60,
        pso=PsoConfig(particles=64, iters=4),
        hand=HandConfig(config_samples=16, joint_sigma=0.2, config_select=0),
    )
    return dict(hand=port_hand(jhand), obj=port_object(jobj), model_pts=np.asarray(
        jobj.model_pts), pose=pose, hb=hb, q_wrong=q_wrong, depth=depth, base=base)


def _cfg(base, sel: int):
    return dataclasses.replace(base, hand=dataclasses.replace(base.hand, config_select=sel))


CONFIGS = (("union", 0), ("select", 3))


def first_stage(sc, seed: int) -> dict:
    """The port's first stage of the test's body at `seed` on its own
    stream: the finger-sample normals [K,J] its hand draws and, per
    configuration, the scene prep's point count."""
    hand = sc["hand"]
    log: list = []
    hand.sampled_clouds = logged_samples(hand, log)
    try:
        out = {"seed": seed, **{name: {"scene_prep_points": scene_points(
            Estimator(sc["obj"], hand, _cfg(sc["base"], sel)), sc, seed)}
            for name, sel in CONFIGS}}
    finally:
        del hand.sampled_clouds
    assert len(log) == 2 and np.array_equal(log[0], log[1])
    out["normals"] = log[0].tolist()
    return out


def config_select_run(sc, seed: int, *, estimates: bool = True) -> dict:
    """The test's body at `seed` on the port's own stream: `first_stage`,
    and with `estimates` each configuration's estimate (scene points and
    ADD-S, m) and both assertions. The evidence assertion reads the scene
    prep's count, which the estimate's n_scene equals (held wherever the
    estimates run); without `estimates` they run only where it holds, as
    the tracking assertion cannot rescue a seed that fails it."""
    out = first_stage(sc, seed)
    u, s = out["union"], out["select"]
    out["evidence"] = s["scene_prep_points"] >= u["scene_prep_points"] + 5
    out["tracking"] = None
    if estimates or out["evidence"]:
        for name, sel in CONFIGS:
            est = Estimator(sc["obj"], sc["hand"], _cfg(sc["base"], sel))
            res = est.estimate(sc["depth"], sc["pose"], sc["hb"], sc["q_wrong"], key=seed)
            out[name]["n_scene"] = float(res.n_scene)
            out[name]["adds_m"] = add_s_error(res.pose.numpy(), sc["pose"], sc["model_pts"])
            assert out[name]["n_scene"] == out[name]["scene_prep_points"], (seed, name)
        out["tracking"] = s["adds_m"] < max(1.5 * u["adds_m"], 0.006)
    out["passed"] = bool(out["evidence"] and out["tracking"])
    return out


def test_config_select_recovers_evidence_under_wrong_nominal_q(scene):
    """A wrong nominal hand_q makes the blind union mask eat object
    evidence; observation-driven selection must keep more scene points AND
    track at least as well: on the port's own stream at seeds 0-7, at
    least as often as the reference on the same scenes (the port's finger
    samples of each seed in the reference's hand)."""
    ref = record()["reference_on_port_samples"]["per_seed"][:SEEDS]
    runs = [config_select_run(scene, s, estimates=False) for s in range(SEEDS)]
    for run, r in zip(runs, ref):
        # the reference ran the scene this run drew, and its first stage
        # kept the same points
        assert run["seed"] == r["seed"]
        np.testing.assert_array_equal(np.float32(run["normals"]), np.float32(r["normals"]))
        for name, _ in CONFIGS:
            assert run[name]["scene_prep_points"] == r[name]["scene_prep_points"], (
                run["seed"], name)
    port = sum(r["passed"] for r in runs)
    assert port >= sum(r["passed"] for r in ref), (
        [(r["seed"], r["evidence"], r["tracking"]) for r in runs], ref)


def test_config_select_scene_points_match_reference_keys(scene, monkeypatch):
    """Over the reference's keys 0-15: with each key's finger samples
    injected, the port's scene prep keeps exactly the points the
    reference's does, under the union (config_select=0) and under selection
    (3); so the evidence assertion holds on the same keys for both."""
    rec = record()
    sc, hand = scene, scene["hand"]
    ests = {name: Estimator(sc["obj"], hand, _cfg(sc["base"], sel)) for name, sel in CONFIGS}
    assert len(rec["per_key"]) == rec["keys"] == 16
    for run in rec["per_key"]:
        monkeypatch.setattr(hand, "sampled_clouds", fixed_samples(
            hand, reference_normals(run["key"], n_joints=hand.n_joints)))
        for name, est in ests.items():
            assert scene_points(est, sc, run["key"]) == run[name]["scene_prep_points"], (
                run["key"], name)


def test_config_select_scene_points_match_reference_on_port_samples(scene):
    """Over seeds 0-15 on the port's own stream: the port's hand draws the
    finger samples recorded for the reference's runs, and its scene prep
    keeps exactly the points the reference's keeps with them."""
    rec = record()["reference_on_port_samples"]
    assert [r["seed"] for r in rec["per_seed"]] == list(range(rec["seeds"]))
    for r in rec["per_seed"]:
        run = first_stage(scene, r["seed"])
        np.testing.assert_array_equal(np.float32(run["normals"]), np.float32(r["normals"]))
        for name, _ in CONFIGS:
            assert run[name]["scene_prep_points"] == r[name]["scene_prep_points"], (
                r["seed"], name)
