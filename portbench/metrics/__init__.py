"""Per-layer metrics, one reader module per metric, found by the metric's
name. Each holds `UNIT` and `read(r)`, which takes a `Readings` and
returns the metric's value, or None where it finds nothing to read (the
harness then leaves the metric out of the line)."""
from __future__ import annotations

import importlib
import pkgutil
from dataclasses import dataclass, field


@dataclass
class Readings:
    """What a traced run hands the readers."""
    config: dict
    frames: int              # frames (steps) of the unprofiled window
    window_s: float          # its length
    latency_s: list          # each frame's latency in it
    spans: dict              # host span name -> total seconds over the window
    program_ms: list         # each frame's card time in the program calls (CUDA events)
    settle_s: float          # set-up's wait for the card to settle
    init_object_frames: int  # object-frames of the window in the init program
    track_object_frames: int
    trace: dict = field(default_factory=dict)   # trace.profile's result

    @property
    def frame_ms(self) -> float:
        return 1e3 * self.window_s / self.frames


def load_all() -> dict:
    return {m.name: importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__)}
