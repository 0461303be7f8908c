"""The kernels' yardstick: one module per kernel wrapper of the program,
found by the wrapper's name as its launch counters give it. Each holds
`PATTERN`, the regular expression that names the kernel in a profiler trace
(demangled or not), and `bound_s(shape)`, the least time the card could
take for one launch at that shape: the larger of its FP32 operations over
the peak rate and its bytes, each read and written once, over the peak
bandwidth. Peaks: NVIDIA's H100 SXM data sheet, dense, at 700 W."""
from __future__ import annotations

import importlib
import pkgutil

PEAK_FP32 = 67e12     # FP32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def load_all() -> dict:
    """{wrapper name: module} for every kernel file here."""
    return {m.name: importlib.import_module(f"{__name__}.{m.name}")
            for m in pkgutil.iter_modules(__path__)}
