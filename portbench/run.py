"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the PyTorch/CUDA package. Prints the
numbers compared against their limits on standard error and one JSON
object as the last line of standard output. Needs a CUDA device; without
one it exits 2 and prints no result."""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _CHECKOUT)
# a fixed cache directory inside the checkout for anything the CUDA driver
# would cache; the program builds its kernels in its package's build/
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(_CHECKOUT, ".portbench_cache", "cuda"))

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
