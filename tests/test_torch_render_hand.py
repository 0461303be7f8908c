"""The port's point splat (exact) and hand model (FK, sampled clouds with
the JAX package's noise injected, render-space config agreement, the
segmentation mask, the occluder depths, hands built from a YAML spec and
the Model O hand) against the JAX package's. FK/clouds/agreement
tolerance: atol 1e-5 (float32 chains of four 4x4 products; agreement sums
~1e3 pixel terms); link points and FK of spec-built hands: 1e-6."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.models import load_hand_spec as jax_load_hand_spec
from icra20_hand_object_pose_tpu.models import make_model_o_hand as jax_model_o
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.ops import render as jrender
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp,
)
from icra20_hand_object_pose_tpu_torch.models import (
    load_hand_spec, make_model_o_hand, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.ops import render
from icra20_hand_object_pose_tpu_torch.utils import rng

torch.set_num_threads(2)

CAM = dict(fx=80.0, fy=80.0, cx=40.0, cy=30.0, height=60, width=80)
HB = hand_base_for_grasp(default_object_pose(0.45))
Q = np.array([0.45, 0.40], np.float32)


def _close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol, rtol=0)


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_splat_depth_exact(radius):
    g = np.random.default_rng(radius)
    pts = np.stack([g.uniform(-0.35, 0.35, 3000), g.uniform(-0.25, 0.25, 3000),
                    g.uniform(0.2, 0.9, 3000)], -1).astype(np.float32)
    pts[:50, 2] = -0.1                      # behind the camera
    pts[50:60, 0] = 5.0                     # far outside the image
    # centres on pixel half-steps: round-half-to-even must match
    pts[60:100, 0] = ((np.arange(40) + 0.5) - CAM["cx"]) / CAM["fx"] * pts[60:100, 2]
    w = (g.random(3000) > 0.1).astype(np.float32)
    ref = jrender.splat_depth(jnp.asarray(pts), jnp.asarray(w), radius=radius, **CAM)
    out = render.splat_depth(torch.tensor(pts), torch.tensor(w), radius=radius, **CAM)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    batch = np.stack([pts, pts[::-1].copy()])
    refb = jrender.splat_depth_batched(jnp.asarray(batch), jnp.asarray(w),
                                       radius=radius, **CAM)
    outb = render.splat_depth_batched(torch.tensor(batch), torch.tensor(w),
                                      radius=radius, **CAM)
    np.testing.assert_array_equal(outb.numpy(), np.asarray(refb))


@pytest.fixture(scope="module")
def hands():
    return jax_t42(points_per_link=64), make_t42_hand(points_per_link=64, device="cpu")


def test_fk_and_cloud(hands):
    jh, th = hands
    _close(th.fk(torch.tensor(Q)), jh.fk(jnp.asarray(Q)))
    _close(th.cloud(torch.tensor(HB), torch.tensor(Q)),
           jh.cloud(jnp.asarray(HB), jnp.asarray(Q)))


def test_sampled_clouds_and_agreement(hands):
    jh, th = hands
    key = jax.random.key(11)
    ref = jh.sampled_clouds(key, jnp.asarray(HB), jnp.asarray(Q), 0.12, 8)
    draws = rng.Draws(jax.random.normal(key, (8, 2)))
    out = th.sampled_clouds(draws, torch.tensor(HB), torch.tensor(Q), 0.12, 8)
    _close(out, ref)
    # observed depth: the nominal hand plus a plane behind it, some holes
    obs = np.asarray(jrender.splat_depth(ref[0], jnp.ones(ref.shape[1]),
                                         radius=2, **CAM))
    obs = np.where(np.isfinite(obs), obs, 0.6).astype(np.float32)
    obs[::7, ::5] = 0.0
    valid = obs > 0
    agree_ref = jh.config_agreement(ref, jnp.asarray(obs), jnp.asarray(valid), **CAM)
    agree = th.config_agreement(out, torch.tensor(obs), torch.tensor(valid), **CAM)
    _close(agree, agree_ref)
    assert len(set(np.round(np.asarray(agree_ref), 4))) == 8  # no ties
    np.testing.assert_array_equal(torch.topk(agree, 3).indices.numpy(),
                                  np.asarray(jax.lax.top_k(agree_ref, 3)[1]))


def test_segment_mask_equal(hands):
    jh, th = hands
    clouds = jh.sampled_clouds(jax.random.key(3), jnp.asarray(HB), jnp.asarray(Q),
                               0.12, 4)                          # [4,Nh,3]
    g = np.random.default_rng(8)
    flat = np.asarray(clouds).reshape(-1, 3)
    # scene points scattered around the hand: some on it, some centimetres off
    scene = (flat[g.integers(0, len(flat), 400)]
             + g.normal(size=(400, 3)) * 0.012).astype(np.float32)
    ref = np.asarray(jh.segment_mask(jnp.asarray(scene), clouds, 0.008))
    out = th.segment_mask(torch.tensor(scene), torch.tensor(np.asarray(clouds)),
                          0.008).numpy()
    assert out.dtype == bool and 40 < out.sum() < 360
    d2 = ((scene[:, None] - flat[None]) ** 2).sum(-1).min(-1)
    clear = np.abs(np.sqrt(d2) - 0.008) > 1e-4     # off the threshold itself
    np.testing.assert_array_equal(out[clear], ref[clear])
    assert np.mean(out != ref) <= 0.01


@pytest.mark.parametrize("radius", [1, 2])
def test_hand_depth_and_union(hands, radius):
    jh, th = hands
    ref = jh.depth(jnp.asarray(HB), jnp.asarray(Q), radius=radius, **CAM)
    out = th.depth(torch.tensor(HB), torch.tensor(Q), radius=radius, **CAM)
    clouds = jh.sampled_clouds(jax.random.key(4), jnp.asarray(HB), jnp.asarray(Q),
                               0.12, 3)
    ref_u = jh.depth_union(jnp.asarray(HB), clouds, radius=radius, **CAM)
    out_u = th.depth_union(torch.tensor(HB), torch.tensor(np.asarray(clouds)),
                           radius=radius, **CAM)
    # the union splats the very same points on both sides: exact
    np.testing.assert_array_equal(out_u.numpy(), np.asarray(ref_u))
    for o, r in ((out.numpy(), np.asarray(ref)),):
        fin = np.isfinite(o)
        assert np.mean(fin != np.isfinite(r)) <= 0.005 and fin.sum() > 50
        both = fin & np.isfinite(r)
        # a point that rounds into the neighbouring pixel swaps two z values
        assert np.mean(np.abs(o[both] - r[both]) > 1e-5) <= 0.01
    assert np.isfinite(out_u.numpy()).sum() >= np.isfinite(out.numpy()).sum()


def _assert_same_hand(th, jh):
    assert th.n_joints == jh.n_joints and th.num_links == jh.num_links
    assert [l.name for l in th.links] == [l.name for l in jh.links]
    assert [l.parent for l in th.links] == [l.parent for l in jh.links]
    _close(th._link_pts, jh._link_pts, atol=1e-6)
    _close(th._link_normals, jh._link_normals, atol=1e-6)
    _close(th._origins, jh._origins, atol=1e-6)
    q = np.linspace(0.2, 0.7, th.n_joints).astype(np.float32)
    _close(th.fk(torch.tensor(q)), jh.fk(jnp.asarray(q)), atol=1e-6)


def test_load_hand_spec_t42():
    spec = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "hand_t42.yaml")
    th = load_hand_spec(spec, device="cpu")
    _assert_same_hand(th, jax_load_hand_spec(spec))
    # the spec reproduces the procedural T42
    proc = make_t42_hand(points_per_link=256, device="cpu")
    _close(th._link_pts, proc._link_pts, atol=1e-6)
    _close(th.fk(torch.tensor(Q)), proc.fk(torch.tensor(Q)), atol=1e-6)


def test_load_hand_spec_mesh_links_and_errors(tmp_path):
    import yaml

    from icra20_hand_object_pose_tpu_torch.utils import meshio

    meshio.save_obj(meshio.make_capsule(radius=0.009, length=0.04),
                    str(tmp_path / "finger.obj"))
    spec = {
        "n_joints": 1, "points_per_link": 32,
        "links": [
            {"name": "palm", "parent": -1,
             "origin": np.eye(4).reshape(-1).tolist(),
             "primitive": {"kind": "sphere", "radius": 0.02}},
            {"name": "finger", "parent": "palm",
             "origin": {"xyz": [0.02, 0.0, 0.01], "rpy": [0.1, -0.2, 0.3]},
             "axis": [0, 2, 0], "joint": 0, "coupling": 0.5, "rest": 0.1,
             "mesh": "finger.obj"},
        ],
    }
    path = str(tmp_path / "hand.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    _assert_same_hand(load_hand_spec(path, device="cpu"), jax_load_hand_spec(path))
    spec["links"][1]["parent"] = "wrist"
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    with pytest.raises(ValueError, match="unknown parent"):
        load_hand_spec(path, device="cpu")
    spec["links"][1].update(parent="palm", joint=1)
    with open(path, "w") as f:
        yaml.safe_dump(spec, f)
    with pytest.raises(ValueError, match="out of range"):
        load_hand_spec(path, device="cpu")


def test_make_model_o_hand():
    th = make_model_o_hand(points_per_link=64, device="cpu")
    jh = jax_model_o(points_per_link=64)
    _assert_same_hand(th, jh)
    assert th.n_joints == 3 and th.num_links == 7
    q = np.array([0.4, 0.5, 0.3], np.float32)
    _close(th.cloud(torch.tensor(HB), torch.tensor(q)),
           jh.cloud(jnp.asarray(HB), jnp.asarray(q)))
