"""`Tracker.step` over a played sequence: one tracker for the whole run,
its init on the first frame and its captures in set-up."""
from __future__ import annotations

import numpy as np

from . import Served, estimator, sub_seed


class Loop:
    def __init__(self, config, traffic, seed, device, spans):
        from icra20_hand_object_pose_tpu_torch.models import Tracker

        self.est = estimator(config, traffic, device)
        self.tracker = Tracker(self.est, seed=sub_seed(seed, 0))
        self.traffic, self.spans = traffic, spans
        spans.instrument(self.est, "estimate", "issue")

    @staticmethod
    def entry(tracker, depth, hand_base, hand_q):
        return tracker.step(depth, hand_base, hand_q)

    def serve(self, i: int) -> Served:
        t = self.traffic
        k = t.index(i)
        with self.spans.span("step"):
            res = self.entry(self.tracker, t.depth[k, 0], t.hand_base[k, 0], t.hand_q)
        with self.spans.span("copy"):
            pose = res.pose.cpu().numpy()
        return Served(k, pose[None], res.fitness[None], res.coverage[None],
                      np.asarray([res.reinitialized]))
