"""The port's pose stream against the JAX package's on one recorded
sequence (a cold start: frame 0 is an init): a 6-frame 160 x 120 sequence
at `__graft_entry__._tiny_setup`'s sizes, generated and saved by the JAX
package, read back by each package's own `RecordedSequence`, tracked by the
JAX `Tracker` at keys 0 and 1 and by the port's `Tracker`.

The rule: the port is held as close to the reference as the reference is
to itself under another key. With d(a, b) the mean over frames of the
ADD-S between two pose streams (`parity.compare_pose_sequences` on the
dense cloud), d(port, ref0) <= k d(ref1, ref0) + m. k and m are measured
by `tests/port_gate_parity.py` (`pose_stream` in
`tests/torch_gate_reference.json`): over 8 sequence seeds, keys 2 and 3 of
the JAX tracker stand in for the port, m = 0, and k is the least ratio
with which both pass on every seed. Measured on the CPU: d(ref1, ref0)
3.8-20.7 mm over the 8 seeds, d(ref2 or ref3, ref0) 3.2-17.6 mm, k =
2.859 (sequence seed 6: 10.942 / 3.827 mm); at this size an init is close
to a coin flip, hence the spread.

Also printed, not a gate: BASELINE.json's reading, "ADD-S within 1 mm of
the reference" (the two streams' mean ADD-S against the ground truth).
The port's `cli eval --ref-poses` runs once on the two dumps.
"""
import contextlib
import io
import os

import numpy as np
import torch

import port_gate_parity as P

torch.set_num_threads(2)


def _dump(poses, root):
    os.makedirs(root)
    for i, p in enumerate(poses):
        np.savetxt(os.path.join(root, f"{i:06d}.txt"), p, fmt="%.9g")
    return root


def test_pose_stream_within_the_reference_spread(tmp_path):
    from icra20_hand_object_pose_tpu.datasets import generate_sequence
    from icra20_hand_object_pose_tpu.datasets.sequence import save_sequence
    from icra20_hand_object_pose_tpu.evaluation import add_s_error
    from icra20_hand_object_pose_tpu.models import Estimator as JaxEstimator
    from icra20_hand_object_pose_tpu_torch import cli
    from icra20_hand_object_pose_tpu_torch.datasets.sequence import RecordedSequence
    from icra20_hand_object_pose_tpu_torch.models import (
        Estimator, ObjectModel, Tracker, make_t42_hand,
    )
    from icra20_hand_object_pose_tpu_torch.utils import meshio

    rule = P.reference_table()["pose_stream"]
    assert rule["sequence_seeds"] >= 8
    cfg, obj, hand = P.tiny_setup()
    frames = generate_sequence(obj.mesh, hand, P.tiny_sequence_config(0, cfg.camera))
    seq_dir = str(tmp_path / "sequence")
    save_sequence(frames, cfg.camera, seq_dir)
    ref_est = JaxEstimator(obj, hand, cfg)
    ref0, ref1 = (P.track_stream(ref_est, seq_dir, k) for k in (0, 1))

    est = Estimator(ObjectModel(obj.mesh, model_points=256, render_points=512,
                                device="cpu"),
                    make_t42_hand(points_per_link=64, device="cpu"), cfg)
    tracker = Tracker(est, seed=0)
    port = [tracker.step(fr.depth, fr.hand_base, fr.hand_q).pose.numpy()
            for fr in RecordedSequence(seq_dir)]
    assert all(p.shape == (4, 4) and np.isfinite(p).all() for p in port)

    d_port = 1000.0 * P.stream_distance(port, ref0, obj.mesh)
    d_ref = 1000.0 * P.stream_distance(ref1, ref0, obj.mesh)
    dense, _ = obj.mesh.sample_surface(8192, seed=123)
    gt = [fr.pose_gt for fr in frames]
    adds = {name: round(1000.0 * float(np.mean([add_s_error(p, g, dense)
                                                 for p, g in zip(s, gt)])), 3)
            for name, s in (("port", port), ("ref0", ref0), ("ref1", ref1))}
    print(f"d(port, ref0) {d_port:.3f} mm, d(ref1, ref0) {d_ref:.3f} mm, rule "
          f"k {rule['k']:.3f} m {rule['m_mm']:.3f} mm; BASELINE reading (not a gate): "
          f"mean ADD-S against the ground truth (mm) {adds}, port - ref0 "
          f"{adds['port'] - adds['ref0']:+.3f} mm")
    assert d_port <= rule["k"] * d_ref + rule["m_mm"], (d_port, d_ref, rule)

    mesh_path = str(tmp_path / "box.obj")
    meshio.save_obj(obj.mesh, mesh_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["eval", "--poses", _dump(port, str(tmp_path / "port")),
                       "--data", seq_dir, "--object", mesh_path,
                       "--ref-poses", _dump(ref0, str(tmp_path / "ref0")),
                       "--device", "cpu"])
    assert rc == 0 and "parity:" in out.getvalue(), out.getvalue()
