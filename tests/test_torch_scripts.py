"""The port's counterparts of the reference's last scripts, on the CPU at
tiny sizes:

- `scripts/calibrate_base_agree_torch.py`: trial 0 of both regimes at a
  160 x 120 camera with the reference's rotation injected: the reported
  base's `config_agreement` equal to the reference's own calls within 1e-5,
  the refine gain finite, and `main` printing the reference's keys;
- `scripts/ab_scan_icp_torch.py`: the variants the reference's `main` runs
  (its `run_variant` replaced by a recorder, so no JAX program is
  compiled), and one tiny variant printing every key;
- `scripts/convert_reference_dataset.py` (the reference's, run as it is):
  a released-layout tree converted by it reads through the port's
  `RecordedSequence`, native and Python, equal to the JAX package's reader.
"""
import importlib.util
import json
import math
import os
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.datasets import (
    SensorModel as JSensorModel, hand_base_for_grasp as jhand_base_for_grasp,
    render_frame as jrender_frame,
)
from icra20_hand_object_pose_tpu.datasets.sequence import (
    RecordedSequence as JRecordedSequence,
)
from icra20_hand_object_pose_tpu.models import make_t42_hand as jmake_t42_hand
from icra20_hand_object_pose_tpu.ops import preprocess as jpreprocess
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio, se3 as jse3
from icra20_hand_object_pose_tpu.utils.config import CameraIntrinsics as JCam
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.datasets.sequence import (
    RecordedSequence, save_sequence,
)
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CAM = dict(width=160, height=120, fx=142.5, fy=142.5, cx=80.0, cy=60.0)
CAL_KEYS = {"score_min", "score_max", "gain_min", "gain_median", "gain_max", "gains"}
AB_KEYS = {"variant", "shape", "ms_per_frame", "tracked_add_mm", "add_mm_median",
           "add_mm_p90", "n_over_5mm", "n_err"}


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- calibrate_base_agree -----------------------------------------------------

@pytest.fixture(scope="module")
def calibrate():
    return _load_script("calibrate_base_agree_torch")


def _reference_trial(t, regime, gt, mesh, hand, cam):
    """Trial t of the reference's main, by its own calls
    (scripts/calibrate_base_agree.py): the reported base and its agreement."""
    factor = 4
    lo = dict(fx=cam.fx / factor, fy=cam.fy / factor, cx=cam.cx / factor,
              cy=cam.cy / factor, height=cam.height // factor,
              width=cam.width // factor)
    hq = np.asarray([0.45, 0.45], np.float32)
    hb = jhand_base_for_grasp(gt)
    if regime == "calibrated":
        hb_rep, q_true, sensor, noise = hb, hq, None, 0.001
    else:
        cal = np.random.default_rng(7000 + t)
        w = cal.normal(size=3)
        w = w / np.linalg.norm(w) * np.radians(3.0)
        v = cal.normal(size=3)
        v = v / np.linalg.norm(v) * 5e-3
        err = np.asarray(jse3.se3_exp(jnp.asarray(np.concatenate([w, v]), jnp.float32)))
        hb_rep = (err @ hb).astype(np.float32)
        q_true = (hq + cal.choice([-0.15, 0.15])).astype(np.float32)
        sensor, noise = JSensorModel(), 0.0
    depth = jrender_frame(mesh, gt, hand, hb, q_true, cam, noise_sigma=noise,
                          rng=np.random.default_rng(50 + t), sensor=sensor)
    d = jnp.asarray(depth)
    d_lo, v_lo = jpreprocess.downsample_depth(d, (d > 0.1) & (d < 2.0), factor)
    a_rep = float(hand.config_agreement(
        hand.cloud(jnp.asarray(hb_rep), jnp.asarray(hq))[None], d_lo, v_lo, **lo)[0])
    return hb_rep, a_rep


@pytest.mark.parametrize("regime", ["calibrated", "miscalibrated"])
def test_calibrate_trial_agreement_matches_reference(calibrate, regime):
    """Trial 0 with the reference's rotation (jax.random.key(100)) injected:
    the same reported base, its agreement equal to the reference's within
    1e-5, and refine_base's gain finite."""
    R = np.asarray(jse3.random_rotation(jax.random.key(100)))
    gt = calibrate.ground_truth(R, np.random.default_rng(3))
    hb_ref, a_ref = _reference_trial(0, regime, gt, jmeshio.make_test_object("box"),
                                     jmake_t42_hand(), JCam(**SMALL_CAM))
    cam, hand = CameraIntrinsics(**SMALL_CAM), make_t42_hand(device="cpu")
    depth, hb_rep = calibrate.trial_frame(0, regime, gt, meshio.make_test_object("box"),
                                          hand, cam, "cpu")
    np.testing.assert_allclose(hb_rep, hb_ref, atol=1e-6)
    d_lo, v_lo = calibrate.observed(depth, "cpu")
    a_rep, gain = calibrate.refine_gain(0, hand, hb_rep, d_lo, v_lo,
                                        calibrate.lo_grid(cam))
    assert abs(a_rep - a_ref) <= 1e-5, (a_rep, a_ref)
    assert math.isfinite(gain)


def test_calibrate_main_prints_reference_keys(calibrate, monkeypatch, capsys):
    """`main(["--trials", "1", "--device", "cpu"])`, its camera cut to
    160 x 120: the reference's JSON, every number finite."""
    monkeypatch.setattr(calibrate, "vga", lambda: CameraIntrinsics(**SMALL_CAM))
    out = calibrate.main(["--trials", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == out and set(out) == {"calibrated", "miscalibrated"}
    for rec in out.values():
        assert set(rec) == CAL_KEYS and len(rec["gains"]) == 1
        assert all(math.isfinite(v) for k, v in rec.items() if k != "gains")
        assert rec["gain_min"] <= rec["gain_median"] <= rec["gain_max"]


# -- ab_scan_icp --------------------------------------------------------------

def _recorded_variants(mod, main, monkeypatch) -> list:
    seen = []
    monkeypatch.setattr(mod, "run_variant", lambda name, pso_kw, icp_kw, *a, **kw:
                        seen.append((name, pso_kw, icp_kw)))
    main()
    return seen


@pytest.mark.parametrize("only", [None, "i1r3,m256,i1r3m256s768"])
def test_ab_scan_variants_equal_reference(monkeypatch, only):
    """The port's variants (and `--only`'s choice of them) are those the
    reference's `main` hands its `run_variant`. The reference script turns
    on the JAX compilation cache when imported: a stand-in keeps it off."""
    monkeypatch.setitem(sys.modules, "icra20_hand_object_pose_tpu.utils.jaxcache",
                        types.SimpleNamespace(enable_compilation_cache=lambda: None))
    ref, ours = _load_script("ab_scan_icp"), _load_script("ab_scan_icp_torch")
    argv = [] if only is None else ["--only", only]
    monkeypatch.setattr(sys, "argv", ["ab_scan_icp.py"] + argv)
    want = _recorded_variants(ref, ref.main, monkeypatch)
    got = _recorded_variants(ours, lambda: ours.main(argv), monkeypatch)
    assert got == want and len(want) == (7 if only is None else 3)


def test_ab_scan_tiny_variant_prints_its_keys(capsys):
    ours = _load_script("ab_scan_icp_torch")
    rec = ours.run_variant("base", {}, {}, 2, 1, device="cpu", width=64, height=48,
                           fov_f=57.6, scene_points=256, particles=32,
                           model_points=256, render_points=512)
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == AB_KEYS and rec["n_err"] == 2
    assert all(math.isfinite(v) and v > 0 for k, v in rec.items()
               if k in ("ms_per_frame", "tracked_add_mm", "add_mm_median", "add_mm_p90"))


# -- convert_reference_dataset, read through the port -------------------------

@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A 3-frame sequence in the released layout (depth, rgb,
    annotated_poses/, hand_pose/, hand_q/, numbered from 7), converted by
    the reference's script."""
    cam = CameraIntrinsics(width=48, height=36, fx=45.0, fy=45.0, cx=24.0, cy=18.0)
    frames = generate_sequence(meshio.make_test_object("box"), make_t42_hand(device="cpu"),
                               SyntheticSequenceConfig(n_frames=3, camera=cam),
                               device="cpu")
    tmp = tmp_path_factory.mktemp("convert")
    root, src = str(tmp / "ours"), tmp / "released"
    save_sequence(frames, cam, root)
    for sub, (ours, ext) in {"depth": ("depth", "png"), "rgb": ("rgb", "png"),
                             "annotated_poses": ("pose_gt", "txt"),
                             "hand_pose": ("hand_base", "txt"),
                             "hand_q": ("hand_q", "txt")}.items():
        (src / sub).mkdir(parents=True)
        for i in range(3):
            shutil.copyfile(os.path.join(root, ours, f"{i:06d}.{ext}"),
                            src / sub / f"{i + 7}.{ext}")
    shutil.copyfile(os.path.join(root, "cam_K.txt"), src / "cam_K.txt")
    dst = str(tmp / "converted")
    assert _load_script("convert_reference_dataset").convert(str(src), dst) == 3
    return dst


@pytest.mark.parametrize("use_native", [True, False])
def test_converted_tree_reads_as_the_reference_reads_it(converted, use_native):
    ours, ref = RecordedSequence(converted, use_native=use_native), JRecordedSequence(converted)
    assert len(ours) == len(ref) == 3
    assert ours.camera.fx == ref.camera.fx and ours.depth_scale == ref.depth_scale
    for i in range(3):
        a, b = ours[i], ref[i]
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        for name in ("pose_gt", "hand_base", "hand_q"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert a.depth.any() and a.hand_q.shape == (2,)
