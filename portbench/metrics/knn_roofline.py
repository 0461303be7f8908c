"""K1-K3's share of their roofline over the profiled frames: the sum of
each launch's bound (kernels/<wrapper>.py at its shape, from the launch
counters) over the kernels' device time by name in the trace. Where the
trace holds fewer of a kernel's launches than the counters, its bound is
scaled by the share traced. Moves frame_ms."""
from .. import kernels

UNIT = "%"


def read(r):
    t = r.trace
    if not t:
        return None
    mods = kernels.load_all()
    bound = spent = 0.0
    for wrapper, (n, shapes) in t["launches"].items():
        traced = t["kernel_traced"].get(wrapper, 0)
        if n <= 0 or traced <= 0 or wrapper not in mods:
            continue
        b = sum(mods[wrapper].bound(shape) * c for shape, c in shapes.items())
        bound += b * traced / n
        spent += t["kernel_s"][wrapper]
    if spent <= 0:
        return None
    return 100.0 * bound / spent
