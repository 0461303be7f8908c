"""Library identification: `LibrarySweep(shared_scene=True).step` over a
played sequence of the held object, every candidate model of the
configuration's `library` scored against the one frame in one step; the
init step and the first tracked step in set-up.

Each step serves the pose, fitness, coverage and re-registration of the
candidate the program names (`SweepResult.named`), picked on the device, so
the step's one read is the served pose. Where the step names another object
than the one held, or none yet (-1: the evidence does not suffice, as on
the first steps of a grasp, which set-up serves), the pose served is
non-finite: a wrong object served as the right one is the worst answer of
this deployment, and the harness counts a step without a pose failed."""
from __future__ import annotations

import torch

from .. import port
from . import Served, sub_seed

# the steps this process's identify loops served, and the kernels' launch
# counts before the first was built: metrics/search_pairs_m.py reads from
# them what every served step searched (set-up, window and profile alike)
SERVED = {"steps": 0, "launches": None}


class Loop:
    def __init__(self, config, traffic, seed, device, spans):
        from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep

        from ..reference import geometry

        hand = port.hand_model(config, geometry.hand_links(config["hand"]), device)
        library = list(config["library"])
        objs = port.object_models(config, [geometry.make_test_object(k) for k in library],
                                  device)
        self.held, = (library.index(k) for k in traffic.kinds)
        self.sweep = LibrarySweep(objs, hand, port.estimator_config(config),
                                  shared_scene=True)
        self.state = self.sweep.init_state(seed=sub_seed(seed, 0))
        self.traffic, self.spans = traffic, spans
        spans.instrument(self.sweep, "_run", "issue")
        if SERVED["launches"] is None:
            SERVED["launches"] = port.launch_counts()

    @staticmethod
    def entry(sweep, state, depth, hand_base, hand_q):
        return sweep.step(state, depth, hand_base, hand_q)

    def serve(self, i: int) -> Served:
        t = self.traffic
        k = t.index(i)
        SERVED["steps"] += 1
        with self.spans.span("step"):
            self.state, res = self.entry(self.sweep, self.state, t.depth[k, 0],
                                         t.hand_base[k, 0], t.hand_q)
            at = torch.clamp(res.named, min=0).reshape(1)

            def pick(x):
                return torch.index_select(x, 0, at)

            pose = torch.where(res.named == self.held, pick(res.poses),
                               torch.full_like(pick(res.poses), float("nan")))
        with self.spans.span("copy"):
            poses = pose.cpu().numpy()
        return Served(k, poses, pick(res.fitness), pick(res.coverage),
                      pick(res.reinitialized))
