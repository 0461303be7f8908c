"""Init-frame parity of the port against the JAX package over many seeds, on
`__graft_entry__._tiny_setup`'s frame: the measurement behind
`tests/test_torch_init.py`'s INIT_MEAN_TOL_MM. Not a test (pytest does not
collect it); run on the CPU from the repo root:

    JAX_PLATFORMS=cpu python tests/port_init_parity.py --seeds 64
    JAX_PLATFORMS=cpu python tests/port_init_parity.py --seeds 24 --no-auto-arm

For the default and the fused-GN configuration it prints each side's
success count (dense ADD-S < 10% of the diameter) and mean ADD-S, and the
spread of the port-minus-reference mean over every window of 3
consecutive seeds.
"""
import argparse
import dataclasses as dc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import __graft_entry__ as ge  # noqa: E402
import test_torch_init as T  # noqa: E402
from icra20_hand_object_pose_tpu.models import Estimator as JaxEstimator  # noqa: E402
from icra20_hand_object_pose_tpu_torch import convert  # noqa: E402
from icra20_hand_object_pose_tpu_torch.models import Estimator  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--no-auto-arm", action="store_true",
                    help="switch the init program's hand-base auto-arm off")
    args = ap.parse_args()
    torch.set_num_threads(4)
    cfg, obj, hand, frame = ge._tiny_setup()
    if args.no_auto_arm:
        cfg = dc.replace(cfg, hand=dc.replace(cfg.hand, base_refine_auto=False))
    tobj = convert.object_from_numpy(
        **{f: np.asarray(getattr(obj, f)) for f in (
            "model_pts", "model_normals", "render_pts", "render_normals",
            "render_w", "symmetries")},
        diameter=obj.diameter, mesh=obj.mesh, device="cpu")
    thand = T._hand_to_port(hand)
    dense, _ = obj.mesh.sample_surface(4096, seed=5)
    limit = 100.0 * obj.diameter
    inputs = (frame.depth, np.eye(4, dtype=np.float32), frame.hand_base,
              frame.hand_q)
    for fused in (False, True):
        c = dc.replace(cfg, icp=dc.replace(cfg.icp, fused_gn=fused))
        ref_est, est = JaxEstimator(obj, hand, c), Estimator(tobj, thand, c)
        if fused:
            ref_est.gn_fn = T._jnp_gn_oracle(est.gn_fn.maxd2, est.gn_fn.min_cos,
                                             est.gn_fn.tau2)
        ref = np.array([T._adds_mm(ref_est.estimate(
            *map(jnp.asarray, inputs), key=jax.random.key(s), mode="init").pose,
            frame, dense) for s in range(args.seeds)])
        port = np.array([T._adds_mm(est.estimate(*inputs, key=s, mode="init").pose,
                                    frame, dense) for s in range(args.seeds)])
        diffs = [port[i:i + 3].mean() - ref[i:i + 3].mean()
                 for i in range(args.seeds - 2)]
        print(f"fused_gn={fused}: reference {int((ref < limit).sum())}/{args.seeds} "
              f"(mean {ref.mean():.2f} mm), port {int((port < limit).sum())}/"
              f"{args.seeds} (mean {port.mean():.2f} mm); 3-seed mean difference "
              f"std {np.std(diffs):.2f} mm, p95 {np.percentile(diffs, 95):.2f} mm, "
              f"max {np.max(diffs):.2f} mm", flush=True)


if __name__ == "__main__":
    main()
