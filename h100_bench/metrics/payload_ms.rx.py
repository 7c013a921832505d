"""Device-timeline ms a step of the payload pass: CUDA events recorded around
each call (a wrapper installed on the instance), every step of the
traced window, averaged."""

LAYER = "payload pass"
UNIT, SOURCE, MOVES = "ms", "program_span", "rx_sps"


def read(rec):
    return rec.get("spans_ms", {}).get("payload")
