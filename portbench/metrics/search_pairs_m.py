"""Millions of correspondence pairs a step searches in K1-K3: P x Ns x Nm of
each launch (the shapes as kernels/ counts them: P posed model clouds of
Nm points against Ns scene points), from the kernels' launch counters over
every step the process's identify loop served (loops/identify.py's
`SERVED`: set-up, settle, window and profile), over those steps. Read over
all of them, not the profiled two: a step that re-registers a candidate
searches ~11 times what a tracked one does, and ~37% of steps do, so the
share of such steps sets the value. Moves frame_ms."""
from .. import port
from ..loops import identify

UNIT = "Mpairs"
WRAPPERS = ("nn_gather_batched", "nn_batched", "nn_gn_batched")


def read(r):
    before, steps = identify.SERVED["launches"], identify.SERVED["steps"]
    if not steps or before is None:
        return None
    now = port.launch_counts()
    pairs = sum(P * Ns * Nm * n
                for w in WRAPPERS if w in now
                for (P, _, Ns, Nm), n in (now[w][1] - before[w][1]).items())
    if pairs <= 0:
        return None
    return 1e-6 * pairs / steps
