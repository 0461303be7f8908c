"""Set-up's wait for the card to settle before the window (harness.settle):
warm frames served until the card's time in the program is within reach
of the fastest this checkout has recorded for the cell. Part of setup_s;
moves setup_s."""

UNIT = "s"


def read(r):
    return r.settle_s if r.program_ms else None
