"""Tables for PERF.md from the nearest-neighbour kernels' timing logs.

    python3 scripts/kernel_ab_table.py OUT      # OUT: the directory of scripts/kernel_ab.sh
    python3 scripts/kernel_ab_table.py --plans  # launch plans of the main-path shapes

The first form reads A1, B1, B2 and A2.log and prints, for each kernel and
shape, the device us per launch of A and B (CUDA graph, the mean of each
side's two runs), B's speed-up, the kernels one call launches, us per call
incl. host issue and host us per call (means of the two runs), and from B's
first run the plain version's, the bound's and the exact-form floor's us.
The second prints, without a card, the plan `nn_plan` / `gn_plan` picks for
each shape of chip_smoke.py's NN_SHAPES and GN_SHAPES, its blocks, and its
warps per SM on a 132-SM H100 (all of a launch's warps over the SMs).
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

LINE = re.compile(
    r"^(K\d) P=(\d+) (?:(?:Pq|G)=(\d+) )?Ns=(\d+) Nm=(\d+) .*?: device ([\d.]+) ms/launch "
    r"\((\d+) kernel\(s\)/call\), call incl\. host issue ([\d.]+) ms, host ([\d.]+) "
    r"us/call, plain ([\d.]+) ms, bound ([\d.]+) ms \((\w+)\), exact-form floor ([\d.]+) ms")


def read(path: Path) -> dict:
    rows = {}
    for line in path.read_text().splitlines():
        m = LINE.match(line)
        if m:
            k, P, Pq, Ns, Nm = m.groups()[:5]
            ms, n, call, host, plain, bound, by, floor = m.groups()[5:]
            rows[(k, int(P), int(Pq or 0), int(Ns), int(Nm))] = dict(
                ms=float(ms), n=int(n), call=float(call), host=float(host),
                plain=float(plain), bound=float(bound), by=by, floor=float(floor))
    return rows


def ab_table(out: str) -> None:
    runs = {t: read(Path(out) / f"{t}.log") for t in ("A1", "B1", "B2", "A2")}
    print("| kernel | P | query | Ns | Nm | A us/launch | B us/launch | B speed-up "
          "| kernels/call | us/call incl. host | host us/call | plain us | bound us "
          "| floor us |")
    print("|---|---|---|---|---|---|---|---|---|---|---|---|---|---|")
    for key in runs["A1"]:
        a = [runs[t][key] for t in ("A1", "A2") if key in runs[t]]
        b = [runs[t][key] for t in ("B1", "B2") if key in runs[t]]
        if len(a) < 2 or len(b) < 2:
            continue

        def mean(xs, f):
            return 1000 * sum(x[f] for x in xs) / len(xs)

        k, P, Pq, Ns, Nm = key
        query = "scene" if k == "K3" else ("shared" if Pq == 1 else "per particle")
        print(f"| {k} | {P} | {query} | {Ns} | {Nm} | {mean(a, 'ms'):.2f} | "
              f"{mean(b, 'ms'):.2f} | {mean(a, 'ms') / mean(b, 'ms'):.2f}x | "
              f"{a[0]['n']} / {b[0]['n']} | {mean(a, 'call'):.1f} / {mean(b, 'call'):.1f} | "
              f"{mean(a, 'host') / 1000:.1f} / {mean(b, 'host') / 1000:.1f} | "
              f"{1000 * b[0]['plain']:.1f} | {1000 * b[0]['bound']:.2f} ({b[0]['by']}) | "
              f"{1000 * b[0]['floor']:.2f} |")


def plans_table() -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import chip_smoke
    from icra20_hand_object_pose_tpu_torch.ops import knn_cuda as kc

    print("| kernel | P | Ns | Nm | plan (q, groups, scene_split, width) | blocks "
          "| threads/block | warps per SM |")
    print("|---|---|---|---|---|---|---|---|")
    for name, shapes, plan_of in (("K1/K2", chip_smoke.NN_SHAPES, kc.nn_plan),
                                  ("K3", chip_smoke.GN_SHAPES, kc.gn_plan)):
        for P, Ns, Nm in shapes:
            plan = plan_of(P, Ns, Nm)
            blocks = P * (plan.scene_split if name == "K3"
                          else kc._tiles(Ns, plan.q, plan.width))
            threads = plan.groups * plan.width
            print(f"| {name} | {P} | {Ns} | {Nm} | {tuple(plan)} | {blocks} | {threads} | "
                  f"{blocks * threads / 32 / kc.SMS:.1f} |")


if __name__ == "__main__":
    if sys.argv[1] == "--plans":
        plans_table()
    else:
        ab_table(sys.argv[1])
