"""Device operations a step in the profiler's trace: every kernel, copy
and fill, the program's own kernels and torch's, from a whole session."""

LAYER, UNIT, SOURCE, MOVES = "bank step", "count", "device_trace", "rx_sps"


def read(rec):
    prof = rec.get("profile")
    return prof["ops_per_step"] if prof and prof["whole"] else None
