"""Closed-loop drivers, one module per entry of the program, found by the
traffic file's `loop`. Each module's `Loop(config, traffic, seed, device,
spans)` builds the program from the benchmark's inputs (no frame served);
`serve(i)` hands the i-th frame of the mix to the entry, waits for its
poses on the host and returns a `Served`. `entry` is the call into the
program, so that a check can break it underneath."""
from __future__ import annotations

import importlib
from typing import NamedTuple

import numpy as np


class Served(NamedTuple):
    frame: int             # index into the traffic's frames
    poses: np.ndarray      # [O,4,4] host poses
    fitness: object        # [O] device tensor
    coverage: object       # [O] device tensor
    reinitialized: object  # [O] bool (host array or device tensor)


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")


def estimator(config: dict, traffic, device):
    """The program's Estimator of the configuration's first object."""
    from icra20_hand_object_pose_tpu_torch.models import Estimator

    from .. import port
    from ..reference import geometry

    hand = port.hand_model(config, geometry.hand_links(config["hand"]), device)
    obj, = port.object_models(config, traffic.meshes[:1], device)
    return Estimator(obj, hand, port.estimator_config(config))


def sub_seed(seed: int, i: int) -> int:
    """A 63-bit seed for the i-th draw of a run seeded with `seed`."""
    return int(np.random.SeedSequence([int(seed), int(i)]).generate_state(
        1, np.uint64)[0] >> 1)
