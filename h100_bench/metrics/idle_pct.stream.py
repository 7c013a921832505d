"""Share of the traced window (the host's span of the profiled steps) in
which no operation ran on the device, from a whole profiler session."""

from h100_bench.trace import idle_pct as read  # noqa: F401

LAYER, UNIT, SOURCE, MOVES = "device", "%", "device_trace", "stream_sps"
