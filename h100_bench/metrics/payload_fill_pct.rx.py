"""The payload pass's fill: the symbols that the accepted packets of the
checked steps carry, 4 (length + 4) each, over the slot-symbols the
program decoded in those steps (its counter ``rx.payload.slot_symbols``,
read around the window), computed after the window. None where the
program keeps no such counter."""

LAYER, UNIT, SOURCE, MOVES = "payload pass", "%", "program_span", "rx_sps"


def read(rec):
    return rec.get("payload_fill_pct")
