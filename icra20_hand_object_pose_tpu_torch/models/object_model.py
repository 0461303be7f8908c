"""Device-ready object model (counterpart of models/object_model.py)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops.pso import principal_axis
from ..utils import meshio


class ObjectModel:
    """Static per-object tensors used by the estimator, on one device.

    model_pts/model_normals: [Nm,3] uniform surface samples (ICP target).
    render_pts/render_normals/render_w: [Nr,3]/[Nr,3]/[Nr] scoring samples.
    symmetries: [S,4,4] discrete symmetry group (identity alone if none).
    slide_axis/slide_extent: [3]/[] the model cloud's principal axis and
                its extent along it (ops/pso.principal_axis), made here
                once: the eigensolver reads its status on the host, which
                a captured frame program cannot.
    diameter:   mesh bounding diameter (meters).
    """

    def __init__(
        self,
        mesh: meshio.Mesh,
        *,
        model_points: int = 1024,
        render_points: int = 2048,
        seed: int = 0,
        device: torch.device | str = "cuda",
    ):
        p, n = mesh.sample_surface(model_points, seed=seed)
        rp, rn = mesh.sample_surface(render_points, seed=seed + 1)
        sym = getattr(mesh, "symmetries", None)
        self._assign(
            mesh=mesh, model_pts=p, model_normals=n, render_pts=rp,
            render_normals=rn, render_w=np.ones((render_points,), np.float32),
            symmetries=(np.eye(4, dtype=np.float32)[None] if sym is None
                        else sym),
            diameter=mesh.diameter(), centroid=mesh.centroid(), device=device,
        )

    @classmethod
    def from_arrays(cls, *, model_pts, model_normals, render_pts,
                    render_normals, render_w, symmetries, diameter,
                    centroid=None, mesh: meshio.Mesh | None = None,
                    device: torch.device | str = "cuda") -> "ObjectModel":
        """Build from precomputed arrays (see convert.object_from_numpy)."""
        obj = cls.__new__(cls)
        obj._assign(mesh=mesh, model_pts=model_pts, model_normals=model_normals,
                    render_pts=render_pts, render_normals=render_normals,
                    render_w=render_w, symmetries=symmetries, diameter=diameter,
                    centroid=centroid, device=device)
        return obj

    def _assign(self, *, mesh, model_pts, model_normals, render_pts,
                render_normals, render_w, symmetries, diameter, centroid,
                device) -> None:
        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=device)

        self.mesh = mesh
        self.device = torch.device(device)
        self.model_pts = t(model_pts)
        self.model_normals = t(model_normals)
        self.render_pts = t(render_pts)
        self.render_normals = t(render_normals)
        self.render_w = t(render_w)
        self.symmetries = t(symmetries)
        self.slide_axis, self.slide_extent = principal_axis(self.model_pts)
        self.diameter = float(diameter)
        self.centroid = (None if centroid is None
                         else np.asarray(centroid, np.float32))

    @classmethod
    def load(cls, path: str, **kwargs) -> "ObjectModel":
        """Load a .obj/.ply mesh file."""
        return cls(meshio.load_mesh(path), **kwargs)

    def tensors(self) -> tuple:
        """(model_pts, model_normals, render_pts, render_normals, render_w,
        symmetries, slide_axis, slide_extent) — the per-object inputs of
        the frame program."""
        return (self.model_pts, self.model_normals, self.render_pts,
                self.render_normals, self.render_w, self.symmetries,
                self.slide_axis, self.slide_extent)
