from .sharding import (  # noqa: F401
    LibrarySweep,
    SweepResult,
    SweepState,
)
