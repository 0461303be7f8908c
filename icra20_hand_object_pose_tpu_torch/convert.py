"""Build the port's models from another implementation's arrays.

`object_from_numpy` and `hand_from_numpy` take plain arrays and plain
attributes (for example the JAX package's `ObjectModel` / `HandModel`
fields read with `np.asarray`), so both implementations compute on the
same samples. Nothing here imports jax.
"""
from __future__ import annotations

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
