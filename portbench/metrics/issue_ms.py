"""Host ms per frame in the program calls: the benchmark's span around
`Estimator.estimate` / `LibrarySweep._run` (input copies, seeding, graph
replay issue, output clones). Unprofiled window; moves frame_ms."""

UNIT = "ms"


def read(r):
    if "issue" not in r.spans or not r.frames:
        return None
    return 1e3 * r.spans["issue"] / r.frames
