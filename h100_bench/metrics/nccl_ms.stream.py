"""Device ms a block of the NCCL kernels (the all-gathers of the block
along the time shards, of the detection metadata and of the result
wires) on rank 0, from a whole profiler session."""

from h100_bench.trace import kernel_s

LAYER, UNIT, SOURCE, MOVES = "multi-card", "ms", "device_trace", "stream_sps"


def read(rec):
    t = kernel_s(rec.get("profile"), "nccl")
    return 1e3 * t if t else None
