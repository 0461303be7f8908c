"""The yardstick's arithmetic: the p95 over all frames, the capped dense
ADD-S, the rigid check, each kernel's bound at the main path's shapes
against chip_smoke.py's figures, and the work count against the program's
`full_refine_equivalents_per_frame`."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

from portbench import kernels, work
from portbench.harness import p95
from portbench.reference import checks, geometry

ROOT = Path(__file__).resolve().parent


def test_p95_over_all_frames():
    lat = np.arange(1, 101, dtype=np.float64)      # 100 frames, 1..100 ms
    assert p95(lat) == pytest.approx(95.05)
    assert p95(np.r_[np.ones(99), 1000.0]) == pytest.approx(1.0)
    assert p95(np.r_[np.ones(90), np.full(10, 50.0)]) == pytest.approx(50.0)


def test_capped_adds():
    box = geometry.make_test_object("box")
    gt = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    gt[:, 2, 3] = 0.5
    est = gt.copy()
    est[1, 0, 3] += 0.002                       # 2 mm off along a face
    est[2] = est[2] @ geometry.se3_exp([0.0, 1.0, 0.0], [0.0, 0.0, 0.0])  # lost
    est[2, 0, 3] += 0.3
    v = checks.judge(est, gt, np.zeros(3, int), np.ones(3), np.ones(3), [box], "cpu")
    limit = checks.REGISTRATION_LIMIT * box.diameter()
    capped = v["adds_capped_m"]
    assert capped[0] == pytest.approx(0.0, abs=2e-4)
    assert 0.0 < capped[1] < 0.002
    assert capped[2] == pytest.approx(limit)
    assert v["compared"]["lost_share"] == pytest.approx(1 / 3)
    # a symmetry of the box is no error beyond the cloud's spacing floor
    flip = gt[0] @ box.symmetries[1]
    e = checks.add_s(flip[None], gt[:1], checks.dense_cloud(box), "cpu")
    assert e[0] < 1.5e-3


def test_non_finite_and_scores():
    box = geometry.make_test_object("box")
    gt = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    est = gt.copy()
    est[1, 0, 0] = np.nan
    v = checks.judge(est, gt, np.zeros(2, int), np.array([1.0, np.inf]),
                     np.array([1.2, 0.5]), [box], "cpu")
    assert v["compared"]["lost_share"] == 0.5
    assert v["compared"]["rigid_err"] == float("inf")
    assert v["compared"]["bad_scores"] == 2.0


def test_rigid_err():
    T = geometry.se3_exp([0.3, -0.2, 0.1], [0.01, 0.02, 0.5])
    assert checks.rigid_err(T[None]) < 1e-6
    B = T.copy()
    B[:3, :3] *= 1.01
    assert checks.rigid_err(B[None]) == pytest.approx(0.0201, rel=1e-3)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# (wrapper, shape, chip_smoke's figure in us at PR 12's shapes)
FIGURES = [
    ("nn_gather_batched", (512, 1, 512, 256), 9.01),     # in-scan
    ("nn_gather_batched", (32, 1, 512, 256), 0.56),      # explorer
    ("nn_gather_batched", (18, 1, 2048, 1024), 5.07),    # polish
    ("nn_gather_batched", (1024, 1, 512, 512), 36.06),   # init scan
    ("nn_batched", (8192, 8, 512, 512), 288.47),         # sweep init
    ("nn_batched", (136, 8, 2048, 1024), 38.31),
    ("nn_gn_batched", (512, 1, 512, 256), 9.43),         # tracked scan
    ("nn_gn_batched", (32, 1, 512, 256), 0.59),
    ("nn_gn_batched", (1024, 1, 512, 512), 36.88),
    ("nn_gn_batched", (8192, 8, 512, 512), 295.04),
]


@pytest.mark.parametrize("wrapper,shape,us", FIGURES)
def test_kernel_bounds(wrapper, shape, us):
    mod = kernels.load_all()[wrapper]
    assert 1e6 * mod.bound(shape) == pytest.approx(us, abs=0.006)
    cs = _chip_smoke()
    P, B, Ns, Nm = shape
    if wrapper == "nn_gn_batched":
        ref_ms, _ = cs.gn_bound(P, B, Ns, Nm)
    else:
        ref_ms, _ = cs.nn_bound(P, B, Ns, Nm, gather=wrapper == "nn_gather_batched")
    assert 1e3 * mod.bound(shape) == pytest.approx(ref_ms, rel=1e-12)


def _config(name):
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["t42_box_vga", "t42_library8_vga"])
def test_work_count(name):
    from icra20_hand_object_pose_tpu_torch.benchmarks import (
        full_refine_equivalents_per_frame)

    from portbench import port

    config = _config(name)
    assert work.refine_equivalents(config["estimator"]) == pytest.approx(
        18.6666667, rel=1e-6)
    assert work.refine_equivalents(config["estimator"]) == pytest.approx(
        full_refine_equivalents_per_frame(port.estimator_config(config)), rel=1e-12)


def test_init_work_count():
    est = _config("t42_box_vga")["estimator"]
    w = work.frame_work(est, "init")
    ks = 512
    scan = 20 * 2 * 1024 * ks * 512
    prescreen = 1024 * ks * 512
    polish = 12 * 17 * 2048 * 1024 + 17 * 2048 * 1024
    assert w["pairs"] == scan + prescreen + polish
    assert w["gn"] == 20 * 2 * 3 * 1024 * ks + 12 * 3 * 17 * 2048
    assert w["ops"] == 9 * w["pairs"] + 105 * w["gn"]


def test_configuration_states_every_counted_size():
    """The program's defaults are not read: the file holds each size, and
    they equal the program's EstimatorConfig built from it."""
    from portbench import port

    config = _config("t42_box_vga")
    cfg = port.estimator_config(config)
    for group, fields in config["estimator"].items():
        if isinstance(fields, dict):
            for k, v in fields.items():
                assert getattr(getattr(cfg, group), k) == v
        else:
            assert getattr(cfg, group) == fields
