"""From the process start to the first timed block: imports, the program's
set-up (the kernel library's load, or its build on a checkout's first
run), the traffic made from the seed and staged, and one warm-up of every
shape the window uses."""

LAYER, UNIT, SOURCE, MOVES = "end to end", "s", "host_clock", None


def read(rec):
    return rec["setup_s"]
