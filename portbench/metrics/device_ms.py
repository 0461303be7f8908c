"""Device ms per frame: every operation's time on the card in the
profiled frames' trace, summed, over the frames. Moves frame_ms."""

UNIT = "ms"


def read(r):
    t = r.trace
    if not t or not t["frames"] or t["device_s"] <= 0:
        return None
    return 1e3 * t["device_s"] / t["frames"]
