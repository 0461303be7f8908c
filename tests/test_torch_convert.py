"""The port's object and hand models hold exactly the JAX package's arrays,
whether converted from them (convert.py) or sampled anew from the same
mesh and seeds (the port copies the numpy mesh sampler)."""
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.models import ObjectModel as JaxObjectModel
from icra20_hand_object_pose_tpu.models import make_t42_hand as jax_t42
from icra20_hand_object_pose_tpu.utils import meshio as jax_meshio
from icra20_hand_object_pose_tpu_torch import convert
from icra20_hand_object_pose_tpu_torch.models import ObjectModel, make_t42_hand
from icra20_hand_object_pose_tpu_torch.utils import meshio

torch.set_num_threads(2)

_OBJ_FIELDS = ("model_pts", "model_normals", "render_pts", "render_normals",
               "render_w", "symmetries")


def _jax_object(kind):
    return JaxObjectModel(jax_meshio.make_test_object(kind), model_points=256,
                          render_points=512)


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("kind", ["box", "mug"])
def test_object_from_numpy_bitwise(kind):
    ref = _jax_object(kind)
    obj = convert.object_from_numpy(
        **{f: np.asarray(getattr(ref, f)) for f in _OBJ_FIELDS},
        diameter=ref.diameter, centroid=ref.centroid, mesh=ref.mesh,
    )
    for f in _OBJ_FIELDS:
        _bitwise(getattr(obj, f).numpy(), getattr(ref, f))
    assert obj.diameter == ref.diameter
    np.testing.assert_array_equal(obj.mesh.vertices, ref.mesh.vertices)


@pytest.mark.parametrize("kind", ["box", "mug"])
def test_object_sampled_natively_bitwise(kind):
    ref = _jax_object(kind)
    obj = ObjectModel(meshio.make_test_object(kind), model_points=256,
                      render_points=512)
    for f in _OBJ_FIELDS:
        _bitwise(getattr(obj, f).numpy(), getattr(ref, f))


def test_hand_from_numpy_bitwise():
    ref = jax_t42(points_per_link=64)
    hand = convert.hand_from_numpy(
        link_pts=np.asarray(ref._link_pts),
        link_normals=np.asarray(ref._link_normals),
        origins=np.asarray(ref._origins), links=ref.links,
        n_joints=ref.n_joints,
    )
    _bitwise(hand._link_pts.numpy(), ref._link_pts)
    _bitwise(hand._link_normals.numpy(), ref._link_normals)
    _bitwise(hand._origins.numpy(), ref._origins)
    for a, b in zip(hand._axes, ref._axes):
        _bitwise(a.numpy(), b)
    assert [(l.name, l.parent, l.joint, l.coupling, l.rest) for l in hand.links] == [
        (l.name, l.parent, l.joint, l.coupling, l.rest) for l in ref.links]


def test_t42_sampled_natively_bitwise():
    ref = jax_t42(points_per_link=64)
    hand = make_t42_hand(points_per_link=64)
    _bitwise(hand._link_pts.numpy(), ref._link_pts)
    _bitwise(hand._link_normals.numpy(), ref._link_normals)
    _bitwise(hand._origins.numpy(), ref._origins)
