#!/bin/sh
# Times the nearest-neighbour kernels (K1, K2, K3) of two checkouts of this
# repository on one CUDA card, in turns A, B, B, A, with the kernel phases of
# this repository's chip_smoke.py (--kernels-only --ungrouped: the shapes
# every checkout's kernels take, without a library's query per group of
# particles): the same shapes, inputs, checks and timing method for both. A checkout needs only its
# icra20_hand_object_pose_tpu_torch package.
#
#   scripts/kernel_ab.sh <checkout A> <checkout B> <output dir>
#
# Writes <output dir>/{A1,B1,B2,A2}.log; exits non-zero if a run fails.
set -eu
smoke="$(cd "$(dirname "$0")/.." && pwd)/chip_smoke.py"
a="$(cd "$1" && pwd)"
b="$(cd "$2" && pwd)"
mkdir -p "$3"
out="$(cd "$3" && pwd)"
for run in A1:"$a" B1:"$b" B2:"$b" A2:"$a"; do
  tag="${run%%:*}"
  dir="${run#*:}"
  (cd "$dir" && PYTHONPATH="$dir" python3 -P "$smoke" --kernels-only --ungrouped) > "$out/$tag.log" 2>&1
  echo "$tag: $(grep -c 'ms/launch' "$out/$tag.log") timed cases"
done
