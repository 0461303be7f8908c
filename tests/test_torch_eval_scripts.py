"""The port's evaluation scripts (`scripts/eval_occlusion_torch.py`,
`scripts/eval_accuracy_torch.py`) against the reference's on the CPU: the
grasp geometry equal, the measured occlusion within 0.01 (the two rasters
differ on under 0.5% of pixels), and one tiny occlusion level and one tiny
tracked sequence print their keys."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.models import make_t42_hand as jmake_t42_hand
from icra20_hand_object_pose_tpu.utils import meshio as jmeshio
from icra20_hand_object_pose_tpu.utils.config import CameraIntrinsics as JCam
from icra20_hand_object_pose_tpu_torch.datasets import (
    default_object_pose, hand_base_for_grasp,
)
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.utils import meshio
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(width=64, height=48, fov_f=57.6, scene_points=256)


def _load_script(name: str):
    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_script_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def occlusion():
    return _load_script("eval_occlusion_torch"), _load_script("eval_occlusion")


@pytest.mark.parametrize("theta", [0.0, 30.0, 65.0, 88.0])
def test_frontal_grasp_base_equals_reference(occlusion, theta):
    ours, ref = occlusion
    pose = default_object_pose()
    np.testing.assert_allclose(ours.frontal_grasp_base(pose, theta),
                               ref.frontal_grasp_base(pose, theta), atol=1e-6)


@pytest.mark.parametrize("shape,theta", [("asym", 0.0), ("box", 50.0), ("box", 88.0)])
def test_measured_occlusion_matches_reference(occlusion, shape, theta):
    ours, ref = occlusion
    pose = default_object_pose()
    hb = (ours.frontal_grasp_base(pose, theta) if theta > 0
          else hand_base_for_grasp(pose))
    hq = np.asarray([0.45, 0.45], np.float32)
    cam = dict(width=160, height=120, fx=140.0, fy=140.0, cx=80.0, cy=60.0)
    got = ours.measured_occlusion(meshio.make_test_object(shape), pose,
                                  make_t42_hand(device="cpu"), hb, hq,
                                  CameraIntrinsics(**cam), device="cpu")
    want = ref.measured_occlusion(jmeshio.make_test_object(shape), pose,
                                  jmake_t42_hand(), hb, hq, JCam(**cam))
    assert want > 0.2
    assert abs(got - want) < 0.01, (got, want)


def test_run_level_prints_its_keys(occlusion, capsys):
    ours, _ = occlusion
    rec = ours.run_level("asym", 0.0, 0.45, 2, 1, theta=50.0, device="cpu",
                         particles=32, model_points=256, render_points=512, **TINY)
    out = json.loads(capsys.readouterr().out)
    assert out == rec
    assert set(out) == {
        "shape", "dy_mm", "curl", "theta_deg", "noise_sigma", "occlusion_pct",
        "adds_mm_tracked_mean", "adds_mm_p90", "add_sym_mm_tracked_mean",
        "add_sym_mm_p90", "rot_deg_mean", "rot_axis_z_mean", "trans_mm_mean",
        "coverage_min", "coverage_mean", "reinit_frames", "n"}
    assert out["n"] == 1 and np.isfinite(out["adds_mm_tracked_mean"])


def test_accuracy_run_prints_its_keys(capsys):
    mod = _load_script("eval_accuracy_torch")
    rec = mod.run("asym", True, True, 2, 32, init_gt=True, device="cpu", **TINY)
    out = json.loads(capsys.readouterr().out)
    assert out == rec
    assert set(out) == {
        "shape", "noise", "subpixel", "frames", "init_gt", "n_hyp", "realistic",
        "adds_mm", "adds_mm_mean", "adds_mm_tracked_mean", "add_mm_mean",
        "sym_add_mm_mean", "rot_deg_mean", "trans_mm_mean", "s_total"}
    assert len(out["adds_mm"]) == 2 and np.isfinite(out["sym_add_mm_mean"])
