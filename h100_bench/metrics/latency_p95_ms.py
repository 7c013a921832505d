"""95th percentile over every block of the window of the time from handing
the block's samples to the entry to its decoded packets on the host."""

import numpy as np

LAYER, UNIT, SOURCE, MOVES = "end to end", "ms", "host_clock", None


def read(rec):
    lat = rec.get("latencies_s")
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
