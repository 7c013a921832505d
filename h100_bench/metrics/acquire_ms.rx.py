"""Device-timeline ms a step of acquire: CUDA events recorded around
each call (a wrapper installed on the instance), every step of the
traced window, averaged."""

LAYER = "acquire"
UNIT, SOURCE, MOVES = "ms", "program_span", "rx_sps"


def read(rec):
    return rec.get("spans_ms", {}).get("acquire")
