"""K5's device ms per frame: the render-and-compare kernel's time by name
in the profiled frames' trace, over the frames. None where K5 never
launched (point-mode scoring, or a program without K5). Moves frame_ms."""

UNIT = "ms"
WRAPPER = "splat_compare_batched"


def read(r):
    t = r.trace
    if not t or not t["frames"]:
        return None
    launched = t["launches"].get(WRAPPER, (0, None))[0]
    spent = t["kernel_s"].get(WRAPPER, 0.0)
    if launched <= 0 or spent <= 0:
        return None
    return 1e3 * spent / t["frames"]
