"""Build the port's models from another implementation's arrays.

`object_from_numpy` and `hand_from_numpy` take plain arrays and plain
attributes (for example the JAX package's `ObjectModel` / `HandModel`
fields read with `np.asarray`), so both implementations compute on the
same samples; `reseeded_key` stands in for the key of a tracker checkpoint
that the JAX package wrote, and `sweep_state_from_numpy` turns a library
sweep's state (its fields as arrays, or its .npz) into the port's. Nothing
here imports jax.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .models.hand import HandLink, HandModel
from .models.object_model import ObjectModel
from .utils import meshio


def _mesh(m) -> meshio.Mesh | None:
    if m is None:
        return None
    sym = getattr(m, "symmetries", None)
    return meshio.Mesh(np.asarray(m.vertices, np.float32),
                       np.asarray(m.faces, np.int32),
                       None if sym is None else np.asarray(sym, np.float32))


def object_from_numpy(
    *,
    model_pts, model_normals, render_pts, render_normals, render_w,
    symmetries, diameter: float, centroid=None, mesh=None,
    device: torch.device | str = "cuda",
) -> ObjectModel:
    """ObjectModel from its arrays: model/render clouds [N,3], render_w [Nr],
    symmetries [S,4,4], diameter (meters); `mesh` (any object with
    vertices/faces) is kept for host-side rendering."""
    return ObjectModel.from_arrays(
        model_pts=model_pts, model_normals=model_normals,
        render_pts=render_pts, render_normals=render_normals,
        render_w=render_w, symmetries=symmetries, diameter=diameter,
        centroid=centroid, mesh=_mesh(mesh), device=device,
    )


def hand_from_numpy(
    *, link_pts, link_normals, origins, links, n_joints: int,
    device: torch.device | str = "cuda",
) -> HandModel:
    """HandModel from its link clouds [L,Pl,3], normals [L,Pl,3], joint
    origins [L,4,4] and link tree: `links` is a sequence of objects with the
    attributes name, mesh, parent, origin, axis, joint, coupling, rest."""
    port_links = [
        HandLink(
            name=str(l.name), mesh=_mesh(l.mesh), parent=int(l.parent),
            origin=np.asarray(l.origin, np.float32),
            axis=np.asarray(l.axis, np.float32), joint=int(l.joint),
            coupling=float(l.coupling), rest=float(l.rest),
        )
        for l in links
    ]
    return HandModel.from_arrays(port_links, n_joints, link_pts, link_normals,
                                 origins, device=device)


def reseeded_key(seed: int, frame_idx: int) -> int:
    """The key a Tracker(seed=seed) of this package holds after `frame_idx`
    frames. Tracker.load uses it for a checkpoint whose `key` field is the
    JAX package's threefry key data (a uint32 pair, meaningless to torch's
    generators): the rest of the state carries over and the random stream
    continues as this package's own would have."""
    from .models.estimator import _split

    key = int(seed)
    for _ in range(int(frame_idx)):
        key, _ = _split(key)
    return key


def sweep_state_from_numpy(state, *, seed: int = 0,
                           device: torch.device | str = "cuda"):
    """The port's `parallel.SweepState` from a library sweep's state: a
    mapping of field name to array, a NamedTuple of them (the JAX package's
    `SweepState`), or the path of an .npz that either package's
    `save_state` wrote. The tensors go to `device`. A `key` that is one
    integer is kept; any other (threefry key data, a typed key, none) is
    left unread and re-derived from `seed` and the frame index by
    `reseeded_key`: the sweep's key advances once per frame, as a
    Tracker's does."""
    from .parallel.sharding import SweepState

    if isinstance(state, (str, os.PathLike)):
        state = np.load(state)
    elif hasattr(state, "_asdict"):
        state = state._asdict()
    fields = {k: state[k] for k in state.keys() if state[k] is not None}

    def tensor(name, dtype):
        if name not in fields:
            return None
        return torch.tensor(np.asarray(fields[name]), dtype=dtype, device=device)

    frame_idx = int(np.asarray(fields["frame_idx"]))
    key = fields.get("key")
    if isinstance(key, np.ndarray) and key.ndim == 0 and key.dtype.kind in "iu":
        key = int(key)
    if not isinstance(key, (int, np.integer)):
        key = reseeded_key(seed, frame_idx)
    f32, b = torch.float32, torch.bool
    return SweepState(
        poses=tensor("poses", f32), fitness=tensor("fitness", f32),
        initialized=tensor("initialized", b), key=int(key), frame_idx=frame_idx,
        coverage=tensor("coverage", f32), hyp_poses=tensor("hyp_poses", f32),
        hyp_fitness=tensor("hyp_fitness", f32),
        prev_poses=tensor("prev_poses", f32), vel_ok=tensor("vel_ok", b),
        pose_tracked=tensor("pose_tracked", b),
        score_sum=tensor("score_sum", torch.float64),
    )
