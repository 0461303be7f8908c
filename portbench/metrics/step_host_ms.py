"""Host ms per frame in the tracker or library sweep itself: the
benchmark's span around `Tracker.step` / `LibrarySweep.step` less its span
around the program call inside it (the watchdog's host read, the priors,
the seeds, the merge). Unprofiled window; moves frame_ms."""

UNIT = "ms"


def read(r):
    if "step" not in r.spans or "issue" not in r.spans or not r.frames:
        return None
    return 1e3 * (r.spans["step"] - r.spans["issue"]) / r.frames
