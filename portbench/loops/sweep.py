"""`LibrarySweep.step` over one played sequence per object: every object
of the library in one step, its init step and first tracked step in
set-up."""
from __future__ import annotations

import numpy as np

from .. import port
from . import Served, sub_seed


class Loop:
    def __init__(self, config, traffic, seed, device, spans):
        from icra20_hand_object_pose_tpu_torch.parallel import LibrarySweep

        from ..reference import geometry

        hand = port.hand_model(config, geometry.hand_links(config["hand"]), device)
        objs = port.object_models(config, traffic.meshes, device)
        self.sweep = LibrarySweep(objs, hand, port.estimator_config(config))
        self.state = self.sweep.init_state(seed=sub_seed(seed, 0))
        self.hand_qs = np.ascontiguousarray(
            np.tile(traffic.hand_q, (len(objs), 1)), np.float32)
        self.traffic, self.spans = traffic, spans
        spans.instrument(self.sweep, "_run", "issue")

    @staticmethod
    def entry(sweep, state, depths, hand_bases, hand_qs):
        return sweep.step(state, depths, hand_bases, hand_qs)

    def serve(self, i: int) -> Served:
        t = self.traffic
        k = t.index(i)
        with self.spans.span("step"):
            self.state, res = self.entry(self.sweep, self.state, t.depth[k],
                                         t.hand_base[k], self.hand_qs)
        with self.spans.span("copy"):
            poses = res.poses.cpu().numpy()
        return Served(k, poses, res.fitness, res.coverage, res.reinitialized)
