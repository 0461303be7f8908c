"""The port's native depth loader (native/: the zlib PNG decoder and the
prefetch thread pool, built with g++ at first use) against the port's
Python codec (utils/pngio.py) and the JAX package's native loader, on
sequences that `save_sequence` writes here."""
import numpy as np
import pytest

from icra20_hand_object_pose_tpu import native as jax_native
from icra20_hand_object_pose_tpu_torch import native
from icra20_hand_object_pose_tpu_torch.datasets import (
    SyntheticSequenceConfig, generate_sequence,
)
from icra20_hand_object_pose_tpu_torch.datasets import sequence
from icra20_hand_object_pose_tpu_torch.models import make_t42_hand
from icra20_hand_object_pose_tpu_torch.utils import meshio, pngio
from icra20_hand_object_pose_tpu_torch.utils.config import CameraIntrinsics


@pytest.fixture(scope="module")
def seq_dir(tmp_path_factory):
    """A 3-frame recorded sequence at 64 x 48, and a 16-bit PNG of random
    values over the whole range beside it."""
    root = tmp_path_factory.mktemp("native")
    cam = CameraIntrinsics(width=64, height=48, fx=58.0, fy=58.0, cx=32.0, cy=24.0)
    frames = generate_sequence(meshio.make_test_object("box"),
                               make_t42_hand(points_per_link=64, device="cpu"),
                               SyntheticSequenceConfig(n_frames=3, camera=cam),
                               device="cpu")
    sequence.save_sequence(frames, cam, str(root / "seq"))
    img = np.random.default_rng(3).integers(0, 65536, (37, 53)).astype(np.uint16)
    pngio.write_png16(str(root / "random.png"), img)
    return root


def test_native_builds():
    assert native.available(), native.build_error()
    assert native.build_error() is None


def test_read_png16_bitwise_codec_and_reference(seq_dir):
    """Every depth frame: the port's native decode == its Python codec ==
    the JAX package's native decode, dtype and bits."""
    seq = sequence.RecordedSequence(str(seq_dir / "seq"), use_native=False)
    assert len(seq) == 3
    for path in seq._depth_files + [str(seq_dir / "random.png")]:
        mine = native.read_png16(path)
        assert mine.dtype == np.uint16 and mine.shape == native.png_dims(path)
        assert np.array_equal(mine, pngio.read_png_gray(path))
        assert np.array_equal(mine, jax_native.read_png16(path))
        assert mine.any()
    assert native.png_dims(seq._depth_files[0]) == (48, 64)


def test_prefetch_frames_in_order(seq_dir):
    """The thread pool yields the frames in order, each equal to the
    codec's read of it, side files included."""
    seq = sequence.RecordedSequence(str(seq_dir / "seq"), use_native=False)
    got = list(native.prefetch_frames(seq._depth_files, seq._load_side,
                                      seq.depth_scale))
    assert [f.index for f in got] == [0, 1, 2]
    for f in got:
        ref = seq[f.index]
        assert np.array_equal(f.depth, ref.depth)
        assert np.array_equal(f.pose_gt, ref.pose_gt)
        assert np.array_equal(f.rgb, ref.rgb)


def test_sequence_native_equals_codec(seq_dir):
    """RecordedSequence(use_native=True) reads what use_native=False reads,
    by index and by iteration; the default takes the native loader."""
    root = str(seq_dir / "seq")
    nat = sequence.RecordedSequence(root, use_native=True)
    py = sequence.RecordedSequence(root, use_native=False)
    assert nat._native is native and py._native is None
    assert sequence.RecordedSequence(root)._native is native
    assert nat.camera == py.camera
    for a, b, c in zip(nat, py, [nat[i] for i in range(len(nat))]):
        for f in ("depth", "pose_gt", "hand_base", "hand_q", "rgb"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert np.array_equal(getattr(c, f), getattr(b, f)), f
        assert a.index == b.index == c.index


def test_truncated_png_raises_as_reference(seq_dir, tmp_path):
    """A PNG cut short raises OSError in the port's loader, as in the
    reference's, and a missing file too."""
    src = (seq_dir / "seq" / "depth" / "000000.png").read_bytes()
    bad = tmp_path / "cut.png"
    bad.write_bytes(src[: len(src) // 2])
    for loader in (native, jax_native):
        with pytest.raises(OSError):
            loader.read_png16(str(bad))
        with pytest.raises(OSError):
            loader.read_png16(str(tmp_path / "missing.png"))
