"""The port's models on the CPU from the JAX package's, by their arrays:
what the behaviour tests hand the port so that both packages see the same
object and hand. Imports no jax (it only reads the models' arrays)."""
import numpy as np

from icra20_hand_object_pose_tpu_torch import convert


def port_object(obj):
    """The port's ObjectModel on the CPU from a JAX ObjectModel's arrays."""
    return convert.object_from_numpy(
        **{f: np.asarray(getattr(obj, f)) for f in (
            "model_pts", "model_normals", "render_pts", "render_normals",
            "render_w", "symmetries")},
        diameter=obj.diameter, mesh=obj.mesh, device="cpu")


def port_hand(hand):
    """The port's HandModel on the CPU from a JAX HandModel's arrays."""
    return convert.hand_from_numpy(
        link_pts=np.asarray(hand._link_pts), link_normals=np.asarray(hand._link_normals),
        origins=np.asarray(hand._origins), links=hand.links, n_joints=hand.n_joints,
        device="cpu")
