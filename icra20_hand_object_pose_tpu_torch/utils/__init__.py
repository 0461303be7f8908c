from . import config, meshio, rng, se3  # noqa: F401
