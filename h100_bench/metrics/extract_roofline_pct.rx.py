"""The step's symbol extractions' least time (``extract_work.py``: each
slot's span of samples read once, its taps read once, its symbols written
once, for the header and the payload pass, however a program chunks them)
over the device time of the kernels named ``fetch_regions`` (K2) and
``matched_filter`` (K3) a step, from a whole profiler session. K2's
launch in acquisition's noise estimate counts in the time too."""

from h100_bench.trace import kernel_s

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "rx_sps"


def read(rec):
    least = rec.get("work", {}).get("extract_least_s")
    k2 = kernel_s(rec.get("profile"), "fetch_regions")
    k3 = kernel_s(rec.get("profile"), "matched_filter")
    return 100.0 * least / (k2 + k3) if least and k2 and k3 else None
