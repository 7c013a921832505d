"""Device-timeline ms a step of the stream transceiver's slide of its
receiver bank (the program's ``TransceiverBank.slide``: the bank's last
``front_pad + pad_tail`` samples copied to its front): CUDA events
recorded around each call (a wrapper installed on the instance), every
step of the traced window, averaged."""

LAYER = "receiver buffer"
UNIT, SOURCE, MOVES = "ms", "program_span", "rx_sps"


def read(rec):
    return rec.get("spans_ms", {}).get("slide")
