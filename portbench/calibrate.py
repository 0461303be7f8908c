"""Readings that set a cell's limits, on the card: the numbers compared
for sound runs of the program on many seeds, for each fault its cell can
have and for the lower-precision control (faults.py), all in one process
so that the kernels build once.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds 11,12,... [--faults stale,altered,control_bf16 --fault-seeds 1,2,3] \
        [--out <file.jsonl>]

Prints one JSON line per run: the seed, the fault (null for a sound run),
`correct` against the cell's current limits, and every number compared."""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import json  # noqa: E402

from portbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="portbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    runs = [(int(s), None) for s in a.seeds.split(",") if s]
    for name in filter(None, a.faults.split(",")):
        runs += [(int(s), name) for s in a.fault_seeds.split(",") if s]
    out = open(a.out, "a") if a.out else None
    try:
        for seed, name in runs:
            fault = (faults.control_bf16 if name == "control_bf16"
                     else faults.FAULTS[name] if name else None)
            r = harness.run(a.workload, seed, a.seconds, False,
                            t_start=time.perf_counter(), fault=fault)
            line = json.dumps({"cell": a.workload, "seed": seed, "fault": name,
                               "correct": r["correct"], "failed": r["failed"],
                               "attempted": r["attempted"],
                               "compared": {k: v["value"] for k, v in r["compared"].items()},
                               "metrics": {k: v["value"] for k, v in r["metrics"].items()}})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
