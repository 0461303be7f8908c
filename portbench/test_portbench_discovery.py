"""Every name in BENCHMARK.json has its file, found by that name, and the
files agree with the entries."""
import json
from pathlib import Path

import pytest

from portbench import harness, kernels, loops, metrics

ROOT = Path(__file__).resolve().parent
BENCH = json.loads((ROOT.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_files(cell):
    spec, config, mix = harness.load_cell(cell["name"])
    assert spec["config"] == cell["config"]
    assert spec["traffic"] == cell["traffic"]
    assert spec["chips"] == cell["chips"] == 1
    assert set(spec["limits"]) == {"adds_mm", "lost_share", "rigid_err", "bad_scores"}
    # the end-to-end metrics it reports are those that list it, or list no cell
    assert spec["end_to_end"] == [
        m["name"] for m in BENCH["end_to_end"]
        if cell["name"] in m.get("workloads", [cell["name"]])]
    assert loops.load(mix["loop"]).Loop
    assert cell["config"] in {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"] == f"portbench/configs/{config['name']}.json"
    data = json.loads((ROOT.parent / config["file"]).read_text())
    assert data["source"] == config["source"]
    assert config["reduced"] == []


def test_every_file_is_named():
    cells = {c["name"] for c in BENCH["workloads"]}
    assert cells == {p.stem for p in (ROOT / "workloads").glob("*.json")}
    assert {c["traffic"] for c in BENCH["workloads"]} == {
        p.stem for p in (ROOT / "traffic").glob("*.json")}
    assert {c["name"] for c in BENCH["configs"]} == {
        p.stem for p in (ROOT / "configs").glob("*.json")}


def test_per_layer_readers():
    readers = metrics.load_all()
    listed = {m["name"]: m for m in BENCH["per_layer"]}
    assert set(listed) == set(readers)
    for name, m in listed.items():
        assert readers[name].UNIT == m["unit"]
        assert m["moves"] == ("setup_s" if name == "settle_s" else "frame_ms")


def test_kernel_files_cover_the_counters():
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda

    assert set(kernels.load_all()) == set(knn_cuda.launch_counts())


def test_end_to_end_names():
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "setup_s", "frame_ms", "frame_ms_p95", "adds_mm"]
