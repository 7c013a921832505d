"""The benchmark of ``gr4_packet_modem_tpu_torch`` on NVIDIA H100 cards.

One command runs one cell once, from the root of a checkout::

    python3 -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in the
repository's ``BENCHMARK.json``; each is a file of its own here, found by
its name: ``configs/<config>.json``, ``traffic/<traffic>.json`` (which
names its entry driver, ``entries/<entry>.py``) and ``metrics/<metric>.py``.
Nothing here imports JAX or the JAX package (``guard.py``).
"""
