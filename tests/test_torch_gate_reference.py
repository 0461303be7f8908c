"""The reference's measured pass rates (`tests/torch_gate_reference.json`)
and pose streams (`tests/torch_ref_pose_stream.json`), both written by
`tests/port_gate_parity.py`, held against the case module: the files load
and carry their command and commit, every case of the six statistical
reference test files (by its pytest id) has an entry, and each entry's
configuration is what `tests/torch_gate_cases.py` builds today."""
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
