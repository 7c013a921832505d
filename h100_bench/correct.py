"""The comparison that decides ``correct``: the program's packets against
the transmitted ones, and the program's stages against the plain
reference receiver (``reference/receiver.py``) on the same samples.

Every number compared is a count or a gap that a sound run keeps at or
under its limit; the limits live in the configuration files
(``"limits"``), set from the readings in PERF.md.
"""

from __future__ import annotations

import numpy as np

# the syncword start that the receiver reports lies this many samples after
# the burst's first sample (the TX filter's delay); a packet is matched to
# the transmitted one whose start is within MATCH_TOL samples of it
SYNC_DELAY = 0
MATCH_TOL = 24


def match_truth(packets, truth, payloads: np.ndarray) -> dict:
    """Hold decoded ``packets`` (``(channel, index, bytes)``; index in the
    coordinates of ``truth``) against ``truth`` (per channel, ``(start,
    pool id, whole)`` of each transmitted packet; the whole ones must
    decode, the others may). Returns counts: ``missed`` (a whole packet
    never decoded right), ``false`` (decoded, but no transmitted packet at
    that place with those bytes), ``dup`` (a transmitted packet decoded
    more than once) and ``expected`` (the whole packets)."""
    found = [set() for _ in truth]
    starts = [np.array([t[0] for t in row], np.int64) for row in truth]
    false = dup = 0
    for chan, index, data in packets:
        if chan >= len(truth) or not len(starts[chan]):
            false += 1
            continue
        j = int(np.argmin(np.abs(starts[chan] + SYNC_DELAY - index)))
        start, pid, _ = truth[chan][j]
        if abs(start + SYNC_DELAY - index) > MATCH_TOL or not np.array_equal(data, payloads[pid]):
            false += 1
        elif j in found[chan]:
            dup += 1
        else:
            found[chan].add(j)
    whole = [{j for j, t in enumerate(row) if t[2]} for row in truth]
    expected = sum(len(w) for w in whole)
    return {"missed": sum(len(w - f) for w, f in zip(whole, found)), "false": false, "dup": dup,
            "expected": expected}


def compare_rows(prog: dict, ref: dict) -> dict:
    """The program's rows ``[C, D]`` against the reference's, both keyed
    as ``ReferenceReceiver.decode``: ``det_diff`` counts valid detections
    (channel, index) that only one side has; over the detections both
    have, ``row_diff`` counts rows whose header (ok, length, type), keep,
    CRC flag, acceptance or accepted bytes differ, and ``esn0_gap_db`` is
    the widest Es/N0 gap."""
    det_diff = row_diff = 0
    gap = 0.0
    for c in range(prog["index"].shape[0]):
        p = {int(i): k for k, i in enumerate(prog["index"][c]) if prog["valid"][c, k]}
        r = {int(i): k for k, i in enumerate(ref["index"][c]) if ref["valid"][c, k]}
        det_diff += len(p.keys() ^ r.keys())
        for i in p.keys() & r.keys():
            a, b = p[i], r[i]
            same = all(prog[f][c, a] == ref[f][c, b]
                       for f in ("header_ok", "packet_type", "keep", "crc_ok", "accepted"))
            if same and prog["header_ok"][c, a]:
                same = prog["length"][c, a] == ref["length"][c, b]
            if same and prog["accepted"][c, a]:
                n = int(prog["length"][c, a])
                same = np.array_equal(prog["data"][c, a, :n], ref["data"][c, b, :n])
            row_diff += not same
            gap = max(gap, abs(float(prog["esn0_db"][c, a]) - float(ref["esn0_db"][c, b])))
    return {"det_diff": det_diff, "row_diff": row_diff, "esn0_gap_db": gap}

