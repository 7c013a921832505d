"""The streaming driver's own ``stats["h2d_s"]`` a block over the window.
It mixes the host staging of the samples with the wait for a free
staging slot (the copy of the block three back)."""

LAYER, UNIT, SOURCE, MOVES = "streaming drivers", "ms", "program_span", "stream_sps"


def read(rec):
    return rec.get("stats_ms", {}).get("h2d")
