"""Channel-samples of every block fed through the streaming driver in the
window, over the window's time, host work and the drain included
(host-fed cells)."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "samples/s", "host_clock", None


def read(rec):
    return rec["samples"] / rec["window_s"] if "blocks" in rec else None
