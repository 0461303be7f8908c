"""A cell cut to a size the CPU runs in seconds, for the tests of the
harness and of its comparison: a 160 x 120 camera, small clouds and
swarms, a few frames, at most two objects. The program's plain path runs
it (its CPU tensors take the kernels' plain versions)."""
from __future__ import annotations

import copy

from . import harness


def tiny_cell(name: str) -> tuple[dict, dict, dict]:
    spec, config, mix = (copy.deepcopy(x) for x in harness.load_cell(name))
    config["camera"] = {"width": 160, "height": 120, "fx": 142.5, "fy": 142.5,
                        "cx": 80.0, "cy": 60.0}
    config["model_points"], config["render_points"] = 256, 512
    config["objects"] = config["objects"][:2]
    est = config["estimator"]
    est["scene_points"], est["model_points"] = 512, 256
    est["pso"].update(particles=64, iters=4)
    est["tracker"].update(reinit_particles=256, reinit_prescreen=1024,
                          prescreen_support=256)
    # a 160 x 120 frame's pixel is ~3.5 mm at half a metre: sound runs of
    # the cut cell read 2.2-5.7 mm, which hides one frame's motion (~2.4
    # mm); the cut cell's limit only stops a lost track
    spec["limits"]["adds_mm"] = 10.0
    mix["frames"] = min(mix["frames"], 6)
    mix["setup_frames"] = min(mix["setup_frames"], 2)
    return spec, config, mix
