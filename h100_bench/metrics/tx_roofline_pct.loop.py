"""The TX's least time (``tx_work.py``: the payload bytes handed in read
once and the bank written once, against 3.35 TB/s) over the device time
of every kernel inside the TX span, from a whole profiler session."""

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "rx_sps"


def read(rec):
    prof = rec.get("profile")
    least = rec.get("work", {}).get("tx_least_s")
    if not prof or not prof["whole"] or not least:
        return None
    t = prof["span_kernel_s"].get("tx")
    return 100.0 * least / t if t else None
