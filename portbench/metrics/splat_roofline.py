"""K5's share of its roofline over the profiled frames: the sum of each
launch's bound (kernels/splat_compare_batched.py at its shape, from the
launch counters) over the kernel's device time by name in the trace, the
bound scaled by the share of the launches traced. None where K5 never
launched. Moves frame_ms."""
from .. import kernels

UNIT = "%"
WRAPPER = "splat_compare_batched"


def read(r):
    t = r.trace
    if not t:
        return None
    launched, shapes = t["launches"].get(WRAPPER, (0, {}))
    traced = t["kernel_traced"].get(WRAPPER, 0)
    spent = t["kernel_s"].get(WRAPPER, 0.0)
    if launched <= 0 or traced <= 0 or spent <= 0:
        return None
    mod = kernels.load_all()[WRAPPER]
    bound = sum(mod.bound(shape) * n for shape, n in shapes.items())
    return 100.0 * bound * traced / launched / spent
