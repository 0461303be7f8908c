"""The reference's measured pass rates (`tests/torch_gate_reference.json`)
and pose streams (`tests/torch_ref_pose_stream.json`), both written by
`tests/port_gate_parity.py`, held against the case module: the files load
and carry their command and commit, every case of the six statistical
reference test files (by its pytest id) has an entry, and each entry's
configuration is what `tests/torch_gate_cases.py` builds today. Likewise
the records that `port_gate_parity.py` writes beside them: the recorded
draws (`tests/torch_gate_draws.json`), the CPU's record of `chip_smoke.py`
phase 17 (d) (`tests/torch_gate_stages_cpu.json`, with the stage
comparison that reads it) and the behaviour reference
(`tests/torch_behaviour_reference.json`)."""
import copy
import inspect
import json
import os

import pytest

import chip_smoke
import port_gate_parity as P
import torch_gate_cases as G

# the six files, and the tests of each that pin accuracy
REFERENCE_TESTS = {
    "test_occlusion_gate.py": None,
    "test_accuracy_regression.py": None,
    "test_realistic_regression.py": None,
    "test_base_refine_auto.py": None,
    "test_init_success.py": None,
    "test_score_concave.py": ["test_tracking_concave_mug"],
}


def reference_ids() -> set:
    """Every pytest id of the gate tests in the six reference files."""
    import importlib

    ids = set()
    for file, only in REFERENCE_TESTS.items():
        module = importlib.import_module(file[:-3])
        for name, fn in inspect.getmembers(module, inspect.isfunction):
            if not name.startswith("test_") or (only and name not in only):
                continue
            marks = [m for m in getattr(fn, "pytestmark", []) if m.name == "parametrize"]
            if not marks:
                ids.add(f"{file}::{name}")
                continue
            m = marks[0]
            for i, vals in enumerate(m.args[1]):
                vals = vals if isinstance(vals, (tuple, list)) else (vals,)
                pid = (m.kwargs["ids"][i] if m.kwargs.get("ids")
                       else "-".join(str(v) for v in vals))
                ids.add(f"{file}::{name}[{pid}]")
    return ids


@pytest.fixture(scope="module")
def table():
    return P.reference_table()


def test_reference_table_covers_every_case(table):
    assert table["command"].startswith("JAX_PLATFORMS=cpu python tests/port_gate_parity.py")
    assert table["commit"] and table["seconds"] > 0 and table["host"]
    assert reference_ids() == set(G.CASES) == set(table["cases"])
    for case, e in table["cases"].items():
        assert e["seeds"] == table["seeds"] == P.SEEDS == len(e["per_seed"]), case
        assert e["passes"] == sum(p["passed"] for p in e["per_seed"]), case
        assert [p["seed"] for p in e["per_seed"]] == list(range(e["seeds"])), case
        for stat, op, limit in e["checks"]:
            assert all(stat in p["stats"] for p in e["per_seed"]), (case, stat)


@pytest.mark.parametrize("case", sorted(G.CASES))
def test_reference_entry_matches_the_case(table, case):
    assert table["cases"][case]["configuration"] == G.configuration(case)


def test_pose_stream_files(table):
    rule = table["pose_stream"]
    assert rule["sequence_seeds"] >= 8 and len(rule["d_mm"]) == rule["sequence_seeds"]
    assert rule["k"] > 0 and rule["m_mm"] >= 0
    assert rule["sequence"]["frames"] == P.STREAM_FRAMES
    vga = json.load(open(P.STREAM_JSON))
    assert vga["command"].startswith("JAX_PLATFORMS=cpu python tests/port_gate_parity.py")
    assert vga["commit"] and vga["seconds"] > 0
    assert {k: vga["sequence"][k] for k in chip_smoke.DEMO} == chip_smoke.DEMO
    for key in ("0", "1"):
        assert len(vga["streams"][key]) == chip_smoke.DEMO["frames"]
        assert all(len(p) == 4 and all(len(r) == 4 for r in p) for p in vga["streams"][key])
    assert os.path.dirname(P.STREAM_JSON) == os.path.dirname(P.REFERENCE_JSON)


def _written_by(rec: dict, only: str) -> None:
    assert rec["command"].startswith("JAX_PLATFORMS=cpu python tests/port_gate_parity.py")
    assert f"--only {only}" in rec["command"]
    assert rec["commit"] and rec["seconds"] > 0 and rec["host"]


def test_recorded_draws_file():
    rec = json.load(open(G.DRAWS_JSON))
    _written_by(rec, "draws")
    assert rec["seeds"] == list(range(P.SEEDS))
    keys = [G._draw_key(c["method"], c["args"]) for c in rec["calls"]]
    assert len(keys) == len(set(keys))
    assert {c["method"] for c in rec["calls"]} == {"rotation", "perturb", "path"}


def test_stage_record_covers_phase_17d():
    rec = json.load(open(G.STAGES_JSON))
    _written_by(rec, "stages")
    assert [(r["level"], r["seed"]) for r in rec["runs"]] == [
        (lv, s) for lv in G.STAGE_LEVELS for s in G.STAGE_SEEDS]
    for r in rec["runs"]:
        assert len(r["frames"]) == 4
        for f in r["frames"]:
            assert set(G.STAGE_ORDER) | {"adds_mm"} == set(f)
            assert len(f["scan_best"]) == G._gate_cfg(G.PortBackend("cpu").config).pso.iters
        assert r["max_adds_mm"] == max(f["adds_mm"] for f in r["frames"][1:])
        assert G.compare_stages(r, r)["first_parting"] is None
    for lv in G.STAGE_LEVELS:
        table = rec["occlusion_cpu_max_adds_mm"][lv]
        # the staged runs are the reference-draw runs of the same scenes
        for r in rec["runs"]:
            if r["level"] == lv:
                assert table["reference_draws"][r["seed"]] == r["max_adds_mm"]
        assert len(table["port_draws"]) == len(table["reference_draws"]) == P.SEEDS


def test_compare_stages_gates_the_deterministic_stages_only():
    """A point count off by more than 0.5% or a centroid by more than 5e-6 m
    fails; the scan's parting is reported, not failed; the counts of the ROI
    and the self-occlusion mask are gated only while the prior agreed."""
    ref = json.load(open(G.STAGES_JSON))["runs"][0]
    run = copy.deepcopy(ref)
    run["frames"][0]["scan_best"][4][3] += 1e-3        # the scan parts
    run["frames"][0]["pose"][3] += 1e-3                # and so the prior of frame 1
    run["frames"][1]["roi_points"] *= 1.1              # not gated: its prior parted
    out = G.compare_stages(run, ref)
    assert out["first_parting"]["frame"] == 0
    assert out["first_parting"]["stage"] == "scan_best[4]"
    assert out["deterministic_failures"] == []
    assert [p and (p["frame"], p["stage"]) for p in out["frame_partings"]] == [
        (0, "scan_best[4]"), (1, "roi_points"), None, None]
    # frames 1-3 alone, carried into frame 1 from the same pose: frame 1's
    # ROI count is gated and reported by its own index
    later = G.compare_stages(dict(frames=run["frames"][1:]), dict(frames=ref["frames"][1:]),
                             frame0=1)
    assert later["deterministic_failures"] == [
        dict(frame=1, stage="roi_points", diff=later["frame_partings"][0]["diff"])]
    run["frames"][2]["scene_points"] *= 1.006
    run["frames"][3]["scene_centroid"][2] += 6e-6
    run["frames"][0]["self_occlusion"] *= 0.99
    bad = {(f["frame"], f["stage"]) for f in G.compare_stages(run, ref)[
        "deterministic_failures"]}
    assert bad == {(2, "scene_points"), (3, "scene_centroid"), (0, "self_occlusion")}
    run = copy.deepcopy(ref)
    run["frames"][1]["scene_points"] *= 1.004           # within 0.5%
    run["frames"][1]["scene_centroid"][0] += 4e-6       # within 5e-6 m
    assert G.compare_stages(run, ref)["deterministic_failures"] == []


def test_behaviour_reference_file():
    """The config-selection test's records: each run's verdicts follow from
    its numbers, the reference's runs on the port's samples took the
    samples the port drew at each seed, and each package's evidence
    outcomes on seeds 0-15 are those of its first stage in the evidence
    rates."""
    rec = json.load(open(P.BEHAVIOUR_JSON))
    _written_by(rec, "behaviour")
    e = rec["test_hand.py::test_config_select_recovers_evidence_under_wrong_nominal_q"]
    own, port, on_port = (e["per_key"], e["port_own_stream"]["per_seed"],
                          e["reference_on_port_samples"]["per_seed"])
    assert e["keys"] == P.BEHAVIOUR_KEYS == len(own) == len(port) == len(on_port)
    assert [r["key"] for r in own] == list(range(e["keys"]))
    assert [r["seed"] for r in port] == [r["seed"] for r in on_port] == list(range(e["keys"]))
    for runs, passes in ((own, e["passes"]), (port, e["port_own_stream"]["passes"]),
                         (on_port, e["reference_on_port_samples"]["passes"])):
        assert passes == sum(r["passed"] for r in runs)
        for r in runs:
            assert r["passed"] == (r["evidence"] and r["tracking"])
            assert r["evidence"] == (r["select"]["n_scene"] >= r["union"]["n_scene"] + 5)
            assert r["tracking"] == (r["select"]["adds_m"] < max(1.5 * r["union"]["adds_m"],
                                                                   0.006))
    for a, b in zip(port, on_port):
        assert a["normals"] == b["normals"]
    rates = e["selection_recovery"]
    for name, runs in (("reference", own), ("port", port)):
        r = rates[name]
        assert len(r["per_seed"]) == rates["draws"] == P.RECOVERY_DRAWS
        assert r["share"] == sum(r["per_seed"]) / rates["draws"]
        assert r["first_16"] == sum(r["per_seed"][:16])
        assert [x["evidence"] for x in runs] == r["per_seed"][:e["keys"]]
    trace = e["seed0_trace"]
    assert trace["normals"] == port[0]["normals"]
    assert len(trace["adds_m"]["port"]) == len(trace["adds_m"]["reference"]) == (
        trace["search_seeds"])
    # search seed 0 of the trace is the port's own run of seed 0
    assert trace["adds_m"]["port"][0]["select"] == port[0]["select"]["adds_m"]
