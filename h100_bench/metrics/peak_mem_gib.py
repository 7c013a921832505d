"""The card's peak allocated memory over the window, less the bytes of
inputs the harness itself staged on the card."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "GiB", "host_clock", None


def read(rec):
    b = rec.get("window_peak_bytes")
    return b / 2**30 if b else None
