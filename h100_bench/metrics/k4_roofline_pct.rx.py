"""K4's (the Costas loop kernel's) least time, its symbols read and
written once at [rows, symbols] for each launch of a step, over its device
time by kernel name, from a whole profiler session."""

from h100_bench.trace import kernel_s

LAYER, UNIT, SOURCE, MOVES = "kernels", "%", "device_trace", "rx_sps"


def read(rec):
    t = kernel_s(rec.get("profile"), "costas_kernel")
    return 100.0 * rec["work"]["k4_least_s"] / t if t else None
