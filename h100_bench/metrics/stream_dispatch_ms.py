"""The streaming driver's own ``stats["dispatch_s"]`` a block over the window."""

LAYER, UNIT, SOURCE, MOVES = "streaming drivers", "ms", "program_span", "stream_sps"


def read(rec):
    return rec.get("stats_ms", {}).get("dispatch")
