"""K5's yardstick and readers: the bound of kernels/splat_compare_batched.py
against chip_smoke.py's `sc_bound` at the pixel cell's shapes, its name in a
trace, `splat_ms` and `splat_roofline` silent where K5 never launched (the
point-mode cells, and a program without K5) and read where it did; and the
pixel cell's configuration, `t42_box_vga`'s but for its scoring."""
import importlib.util
import json
from collections import Counter
from pathlib import Path

import pytest

from portbench import kernels, metrics

ROOT = Path(__file__).resolve().parent
WRAPPER = "splat_compare_batched"
# (P, Nr, H, W): the tracked scan, explorer, polish and finisher, the
# init's prescreen, scan and polish
SHAPES = [(512, 512, 120, 160), (32, 512, 120, 160), (18, 2048, 480, 640),
          (512, 2048, 480, 640), (4096, 512, 120, 160), (1024, 512, 120, 160),
          (17, 2048, 480, 640)]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", SHAPES)
def test_k5_bound(shape):
    ms, by = _chip_smoke().sc_bound(*shape)
    assert 1e3 * kernels.load_all()[WRAPPER].bound(shape) == pytest.approx(ms, rel=1e-12)
    assert by == "bytes"


def test_k5_pattern():
    pat = kernels.load_all()[WRAPPER].PATTERN
    assert pat.search("(anonymous namespace)::splat_compare_kernel((anonymous namespace)::Params)")
    assert pat.search("_ZN12_GLOBAL__N_120splat_compare_kernelENS_6ParamsE")
    assert not pat.search("void (anonymous namespace)::gn_iterate_kernel<128, 0>(float const*)")
    for name, mod in kernels.load_all().items():
        if name != WRAPPER:
            assert not mod.PATTERN.search("splat_compare_kernel(Params)")


def _readings(trace: dict):
    return metrics.Readings(config={}, frames=10, window_s=1.0, latency_s=[0.1] * 10,
                            spans={}, program_ms=[], settle_s=0.0, init_object_frames=0,
                            track_object_frames=10, trace=trace)


def test_readers_silent_without_k5():
    readers = metrics.load_all()
    trace = {"frames": 2, "launches": {"nn_gather_batched": (6, Counter({(512, 1, 512, 256): 6}))},
             "kernel_s": {"nn_gather_batched": 1e-4}, "kernel_traced": {"nn_gather_batched": 6}}
    for t in ({}, trace):
        assert readers["splat_ms"].read(_readings(t)) is None
        assert readers["splat_roofline"].read(_readings(t)) is None


def test_readers_with_k5():
    readers = metrics.load_all()
    shapes = Counter({SHAPES[0]: 22, SHAPES[3]: 8})
    trace = {"frames": 2, "launches": {WRAPPER: (30, shapes)},
             "kernel_s": {WRAPPER: 2e-3}, "kernel_traced": {WRAPPER: 27}}
    r = _readings(trace)
    assert readers["splat_ms"].read(r) == pytest.approx(1.0)
    b = sum(kernels.load_all()[WRAPPER].bound(s) * n for s, n in shapes.items())
    assert readers["splat_roofline"].read(r) == pytest.approx(100.0 * b * 27 / 30 / 2e-3)


def test_pixel_config_is_the_box_scored_by_pixel():
    def load(name):
        return json.loads((ROOT / "configs" / f"{name}.json").read_text())

    point, pixel = load("t42_box_vga"), load("t42_box_vga_pixel")
    assert pixel["estimator"]["score"].pop("mode") == "pixel"
    assert point["estimator"]["score"].pop("mode") == "point"
    assert pixel.pop("assumed").pop("renderer") and pixel.pop("deployment")
    point.pop("assumed"), point.pop("deployment")
    # the same paper, down to the part that defines this deployment
    source = pixel.pop("source")
    assert source.startswith(point.pop("source") + " - ") and "render-and-compare" in source
    assert pixel == point
