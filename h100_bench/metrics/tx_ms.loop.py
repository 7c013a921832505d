"""Device-timeline ms a step of the transceiver's TX (the program's
``TransceiverBank.transmit``: framing, shaping and the layout into the
bank): CUDA events recorded around each call (a wrapper installed on the
instance), every step of the traced window, averaged."""

LAYER = "transmitter"
UNIT, SOURCE, MOVES = "ms", "program_span", "rx_sps"


def read(rec):
    return rec.get("spans_ms", {}).get("tx")
