"""The device's idle share of the window: 1 - the card's time in the
program calls (CUDA events around each call, summed over the window's
frames) over the window's length, both from the same unprofiled frames.
Work the card does outside the programs (the eager glue around them)
counts as idle here; the profiled `device_ms` holds all of it. Moves
frame_ms."""

UNIT = "%"


def read(r):
    if not r.program_ms or not r.window_s:
        return None
    return 100.0 * (1.0 - 1e-3 * sum(r.program_ms) / r.window_s)
