"""The device mesh (mesh.py) and the multi-object library sweep
(sharding.py). The sweep's names load on first use: ops/pso.py and
models/estimator.py import parallel.mesh, and sharding.py imports them."""
from .mesh import all_gather, is_writer, make_mesh, mesh_axis, spawn_ranks  # noqa: F401

_SHARDING = ("LibrarySweep", "SweepResult", "SweepState")


def __getattr__(name):
    if name in _SHARDING:
        from . import sharding

        return getattr(sharding, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
