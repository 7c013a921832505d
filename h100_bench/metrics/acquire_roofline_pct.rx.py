"""Acquire's least time (work.acquire_work: the correlation's operations
counted from shapes, the bank read once, the detections written once,
against 67 TFLOP/s and 3.35 TB/s) over the device time of every kernel
inside the acquire span, from a whole profiler session."""

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "rx_sps"


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["whole"]:
        return None
    t = prof["span_kernel_s"].get("acquire")
    return 100.0 * rec["work"]["acquire_least_s"] / t if t else None
