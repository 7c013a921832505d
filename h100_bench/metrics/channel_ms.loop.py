"""Device-timeline ms a step of the transceiver's channel (the program's
``TransceiverBank.impair``: each link rotated by its carrier offset and
phase, AWGN, into the receiver's bank): CUDA events recorded around each
call (a wrapper installed on the instance), every step of the traced
window, averaged."""

LAYER = "channel"
UNIT, SOURCE, MOVES = "ms", "program_span", "rx_sps"


def read(rec):
    return rec.get("spans_ms", {}).get("channel")
