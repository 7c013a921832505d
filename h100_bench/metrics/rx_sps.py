"""Channel-samples of every bank step completed in the window, over the
window's time (resident cells)."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "samples/s", "host_clock", None


def read(rec):
    return rec["samples"] / rec["window_s"] if "steps" in rec else None
