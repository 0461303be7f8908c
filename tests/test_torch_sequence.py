"""The port's exact triangle raster, synthetic sequence generator, recorded
sequence I/O, PNG codec and Tracker checkpoints against the JAX package's,
on the CPU.

Tolerances: `raster_depth`: pixels valid in both images agree to 1e-5 m and
validity differs on at most 0.5% of the pixels (an edge pixel may flip with
the last bit of a barycentric); `generate_sequence`: `pose_gt` and
`hand_base` within 1e-6, depth as the raster (both packages draw the same
numpy noise and dropout); files written by one package and read by the
other are equal; a resumed Tracker's poses are bitwise those of the
uninterrupted run."""
import dataclasses
import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from icra20_hand_object_pose_tpu.datasets import (
    SensorModel as JaxSensorModel,
    SyntheticSequenceConfig as JaxSeqConfig,
    generate_sequence as jax_generate_sequence,
)
from icra20_hand_object_pose_tpu.datasets import sequence as jsequence
from icra20_hand_object_pose_tpu.models import (
    Estimator as JaxEstimator, ObjectModel as JaxObjectModel,
    Tracker as JaxTracker, make_t42_hand as jax_t42,
)
from icra20_hand_object_pose_tpu.ops import render as jrender
from icra20_hand_object_pose_tpu.utils import pngio as jpngio
from icra20_hand_object_pose_tpu_torch import convert, datasets
from icra20_hand_object_pose_tpu_torch.datasets import (
    SensorModel, SyntheticSequenceConfig, generate_sequence,
    hand_base_for_grasp, default_object_pose,
)
from icra20_hand_object_pose_tpu_torch.datasets import sequence
from icra20_hand_object_pose_tpu_torch.models import (
    Estimator, ObjectModel, Tracker, make_t42_hand,
)
from icra20_hand_object_pose_tpu_torch.models.hand import _rpy_matrix
from icra20_hand_object_pose_tpu_torch.ops import render
from icra20_hand_object_pose_tpu_torch.utils import meshio, pngio
from icra20_hand_object_pose_tpu_torch.utils.config import (
    CameraIntrinsics, EstimatorConfig, PsoConfig, TrackerConfig,
)

torch.set_num_threads(2)


def _cam(w, h):
    return CameraIntrinsics(width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                            cx=w / 2, cy=h / 2)


def _assert_depth_close(a, b, empty):
    """a, b depth images; `empty(x)` marks their empty pixels."""
    va, vb = ~empty(a), ~empty(b)
    assert np.mean(va != vb) <= 0.005
    both = va & vb
    assert both.sum() > 30
    np.testing.assert_allclose(a[both], b[both], atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def hands():
    return jax_t42(points_per_link=64), make_t42_hand(points_per_link=64,
                                                      device="cpu")


def _tilted(base, rx, ry, rz):
    """`base` with its rotation replaced by the Euler angles (rx, ry, rz)."""
    T = np.array(base, np.float32)
    T[:3, :3] = _rpy_matrix((rx, ry, rz))
    return T


@pytest.mark.parametrize("size", [(64, 48), (160, 120)])
@pytest.mark.parametrize("what", ["box", "hand"])
def test_raster_depth(hands, what, size):
    cam = _cam(*size)
    pose = default_object_pose(0.45)
    if what == "box":
        # a tilted box: edges off the pixel grid, one vertex behind the camera
        mesh = meshio.make_test_object("box").transformed(
            _tilted(pose, 0.4, -0.3, 0.2))
        verts = np.array(mesh.vertices, np.float32)
        verts[0, 2] = -0.05
    else:
        mesh = hands[1].merged_mesh(np.array([0.5, 0.4], np.float32)).transformed(
            hand_base_for_grasp(pose))
        verts = np.asarray(mesh.vertices, np.float32)
    kw = dict(fx=cam.fx, fy=cam.fy, cx=cam.cx, cy=cam.cy,
              height=cam.height, width=cam.width)
    ref = np.asarray(jrender.raster_depth(
        jnp.asarray(verts), jnp.asarray(mesh.faces, jnp.int32), **kw))
    out = render.raster_depth(torch.tensor(verts),
                              torch.tensor(np.asarray(mesh.faces)), **kw).numpy()
    assert out.shape == (cam.height, cam.width) and out.dtype == np.float32
    _assert_depth_close(out, ref, lambda d: ~np.isfinite(d))


def test_raster_depth_no_faces():
    out = render.raster_depth(torch.zeros((3, 3)), torch.zeros((0, 3), dtype=torch.int64),
                              fx=50.0, fy=50.0, cx=8.0, cy=6.0, height=12, width=16)
    assert out.shape == (12, 16) and bool(torch.isinf(out).all())


@pytest.mark.parametrize("variant", ["default", "sensor_and_mount_error"])
def test_generate_sequence_matches_reference(hands, variant):
    cam = _cam(64, 48)
    mesh = meshio.make_test_object("box")
    kw = dict(n_frames=3, camera=cam, seed=3)
    if variant == "default":
        ref_cfg, cfg = JaxSeqConfig(**kw), SyntheticSequenceConfig(**kw)
    else:
        kw.update(hand_base_err_mm=5.0, hand_base_err_deg=3.0)
        ref_cfg = JaxSeqConfig(sensor=JaxSensorModel(), **kw)
        cfg = SyntheticSequenceConfig(sensor=SensorModel(), **kw)
    ref = jax_generate_sequence(mesh, hands[0], ref_cfg)
    out = generate_sequence(mesh, hands[1], cfg, device="cpu")
    assert len(out) == len(ref) == 3
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.pose_gt, b.pose_gt, atol=1e-6, rtol=0)
        np.testing.assert_allclose(a.hand_base, b.hand_base, atol=1e-6, rtol=0)
        np.testing.assert_array_equal(a.hand_q, b.hand_q)
        assert a.depth.dtype == np.float32 and a.rgb.dtype == np.uint8
        # the sensor model's edge jitter moves whole pixels, so a flipped
        # raster pixel can land elsewhere: the tolerance stays the raster's
        _assert_depth_close(a.depth, b.depth, lambda d: d <= 0)
        assert np.mean(a.rgb != b.rgb) <= 0.02
    # the object moves: 2 degrees and 4 mm per frame
    assert np.linalg.norm(out[2].pose_gt[:3, 3] - out[0].pose_gt[:3, 3]) > 0.006


def test_renders_default_to_the_card():
    for fn in (datasets.render_frame, datasets.render_frame_fast,
               datasets.generate_sequence):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.fixture(scope="module")
def tiny_frames(hands):
    cam = _cam(64, 48)
    frames = generate_sequence(
        meshio.make_test_object("box"), hands[1],
        SyntheticSequenceConfig(n_frames=4, camera=cam), device="cpu")
    return cam, frames


def test_sequence_round_trip_both_ways(tiny_frames, tmp_path):
    cam, frames = tiny_frames
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    sequence.save_sequence(frames, cam, mine)
    jsequence.save_sequence(frames, cam, theirs)
    for sub in ("depth", "rgb", "pose_gt", "hand_base", "hand_q"):
        for name in sorted(os.listdir(os.path.join(theirs, sub))):
            with open(os.path.join(mine, sub, name), "rb") as f, \
                    open(os.path.join(theirs, sub, name), "rb") as g:
                assert f.read() == g.read(), (sub, name)
    # each package reads the other's files; the native loader stays off
    seq = sequence.RecordedSequence(theirs)
    ref = jsequence.RecordedSequence(mine, use_native=False)
    assert len(seq) == len(ref) == 4
    assert dataclasses.asdict(seq.camera) == dataclasses.asdict(ref.camera)
    assert (seq.camera.width, seq.camera.height) == (64, 48)
    for a, b, src in zip(seq, ref, frames):
        np.testing.assert_array_equal(a.depth, b.depth)
        np.testing.assert_array_equal(a.rgb, b.rgb)
        np.testing.assert_array_equal(a.pose_gt, b.pose_gt)
        np.testing.assert_array_equal(a.hand_base, b.hand_base)
        np.testing.assert_array_equal(a.hand_q, b.hand_q)
        assert a.index == b.index
        # 16-bit millimetres: within half a depth unit of what was saved
        assert np.abs(a.depth - src.depth).max() <= 0.5 * cam.depth_scale + 1e-7
        np.testing.assert_allclose(a.pose_gt, src.pose_gt, atol=1e-6)
    assert seq[2].index == 2


def test_sequence_errors(tiny_frames, tmp_path):
    cam, frames = tiny_frames
    with pytest.raises(FileNotFoundError, match="not a sequence dir"):
        sequence.RecordedSequence(str(tmp_path / "missing"))
    root = str(tmp_path / "seq")
    sequence.save_sequence(frames[:1], cam, root)
    # a native loader that cannot be built: True raises, None falls back
    from icra20_hand_object_pose_tpu_torch import native

    saved = native._lib, native._build_error
    native._lib, native._build_error = None, "no compiler"
    try:
        with pytest.raises(RuntimeError, match="not available: no compiler"):
            sequence.RecordedSequence(root, use_native=True)
        assert sequence.RecordedSequence(root)._native is None
    finally:
        native._lib, native._build_error = saved


@pytest.mark.parametrize("kind", ["gray16", "gray8_filtered", "rgb"])
def test_pngio_matches_reference(kind, tmp_path):
    g = np.random.default_rng(4)
    a, b = str(tmp_path / "a.png"), str(tmp_path / "b.png")
    if kind == "gray16":
        img = g.integers(0, 65536, (37, 53)).astype(np.uint16)
        pngio.write_png16(a, img)
        jpngio.write_png16(b, img)
        read, jread = pngio.read_png_gray, jpngio.read_png_gray
    elif kind == "rgb":
        img = g.integers(0, 256, (21, 34, 3)).astype(np.uint8)
        pngio.write_png_rgb(a, img)
        jpngio.write_png_rgb(b, img)
        read, jread = pngio.read_png_rgb, jpngio.read_png_rgb
    else:
        # an 8-bit file with all five scanline filters, built by hand
        import struct
        import zlib

        img = g.integers(0, 256, (10, 16)).astype(np.uint8)
        rows, prev = b"", np.zeros(16, np.int64)
        for y in range(10):
            cur = img[y].astype(np.int64)
            left = np.concatenate([[0], cur[:-1]])
            ul = np.concatenate([[0], prev[:-1]])
            ft = y % 5
            if ft == 0:
                enc = cur
            elif ft == 1:
                enc = cur - left
            elif ft == 2:
                enc = cur - prev
            elif ft == 3:
                enc = cur - (left + prev) // 2
            else:
                p = left + prev - ul
                pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
                pred = np.where((pa <= pb) & (pa <= pc), left,
                                np.where(pb <= pc, prev, ul))
                enc = cur - pred
            rows += bytes([ft]) + (enc % 256).astype(np.uint8).tobytes()
            prev = cur

        def chunk(tag, payload):
            return (struct.pack(">I", len(payload)) + tag + payload
                    + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

        data = (b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 16, 10, 8, 0, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
        for p in (a, b):
            with open(p, "wb") as f:
                f.write(data)
        read, jread = pngio.read_png_gray, jpngio.read_png_gray
    with open(a, "rb") as f, open(b, "rb") as h:
        assert f.read() == h.read()
    out = read(b)
    np.testing.assert_array_equal(out, jread(a))
    np.testing.assert_array_equal(out, img)


# -- Tracker checkpoints ------------------------------------------------------

def _tiny_cfg(cam, **tracker):
    return EstimatorConfig(
        camera=cam, scene_points=256, render_size=cam.height,
        pso=PsoConfig(particles=16, iters=2, icp_iters_inner=2,
                      finish_iters=2, finish_particles=16),
        tracker=TrackerConfig(reinit_particles=16, reinit_prescreen=32, **tracker))


def _seeded(tracker, frame):
    tracker.state = tracker.state._replace(pose=tracker.est._tensor(frame.pose_gt),
                                           initialized=True, fitness=1.0)
    return tracker


@pytest.mark.parametrize("variant", ["velocity", "two_hypotheses"])
def test_tracker_save_load_resumes_bitwise(tiny_frames, hands, variant, tmp_path):
    cam, frames = tiny_frames
    cfg = _tiny_cfg(cam, **({"motion_prior": 1.0} if variant == "velocity"
                            else {"n_hypotheses": 2}))
    obj = ObjectModel(meshio.make_test_object("box"), model_points=256,
                      render_points=512, device="cpu")
    est = Estimator(obj, hands[1], cfg)
    whole = _seeded(Tracker(est, seed=5), frames[0])
    poses = []
    for i, fr in enumerate(frames):
        poses.append(whole.step(fr.depth, fr.hand_base, fr.hand_q).pose)
        if i == 1:
            whole.save(str(tmp_path / "ckpt"))      # no suffix: .npz is added
    assert os.path.exists(str(tmp_path / "ckpt.npz"))
    resumed = Tracker(est, seed=99)
    resumed.load(str(tmp_path / "ckpt"))
    st = resumed.state
    assert st.frame_idx == 2 and isinstance(st.key, int) and st.initialized is True
    assert st.pose.device == est.device and st.pose.dtype == torch.float32
    assert st.pose_tracked and st.prev_pose is not None
    assert (st.hyp_poses is not None) == (variant == "two_hypotheses")
    for i in (2, 3):
        fr = frames[i]
        out = resumed.step(fr.depth, fr.hand_base, fr.hand_q)
        assert out.frame_idx == i and not out.reinitialized
        assert torch.equal(out.pose, poses[i])


def test_reference_checkpoint_loads(tiny_frames, hands, tmp_path):
    cam, frames = tiny_frames
    cfg = _tiny_cfg(cam)
    mesh = meshio.make_test_object("box")
    jtracker = JaxTracker(JaxEstimator(
        JaxObjectModel(mesh, model_points=256, render_points=512), hands[0], cfg))
    jtracker.state = jtracker.state._replace(
        pose=jnp.asarray(frames[0].pose_gt), initialized=jnp.asarray(True),
        fitness=jnp.asarray(1.0))
    for fr in frames[:2]:
        jtracker.step(jnp.asarray(fr.depth), jnp.asarray(fr.hand_base),
                      jnp.asarray(fr.hand_q))
    path = str(tmp_path / "jax_ckpt.npz")
    jtracker.save(path)
    assert np.load(path)["key"].shape == (2,)          # threefry key data

    est = Estimator(ObjectModel(mesh, model_points=256, render_points=512,
                                device="cpu"), hands[1], cfg)
    tracker = Tracker(est, seed=7)
    tracker.load(path)
    st, jst = tracker.state, jtracker.state
    np.testing.assert_array_equal(st.pose.numpy(), np.asarray(jst.pose))
    np.testing.assert_array_equal(st.prev_pose.numpy(), np.asarray(jst.prev_pose))
    assert st.frame_idx == 2 and st.initialized is True and st.pose_tracked
    assert float(st.fitness) == float(jst.fitness)
    assert float(st.coverage) == float(jst.coverage)
    # the key is what a port Tracker(seed=7) holds after two frames
    assert st.key == convert.reseeded_key(7, 2) != convert.reseeded_key(7, 1)
    fresh = Tracker(est, seed=7)
    _seeded(fresh, frames[0])
    for fr in frames[:2]:
        fresh.step(fr.depth, fr.hand_base, fr.hand_q)
    assert fresh.state.key == st.key
    out = tracker.step(frames[2].depth, frames[2].hand_base, frames[2].hand_q)
    assert out.frame_idx == 2 and not out.reinitialized
    assert bool(torch.isfinite(out.pose).all())
