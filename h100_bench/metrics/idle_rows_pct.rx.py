"""The IDLE rows among the rows that the stream steps of the window kept
with a good header: the program's own counts, added on the card by every
step (a replayed one too) and read around the window. None where the
program keeps no such counts."""

LAYER, UNIT, SOURCE, MOVES = "payload pass", "%", "program_counter", "rx_sps"


def read(rec):
    return rec.get("idle_rows_pct")
