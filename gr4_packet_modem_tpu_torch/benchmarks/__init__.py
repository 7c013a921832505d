"""The repo's measurement programs on the PyTorch port (ports of
``benchmarks/*.py``; ``bench.py``'s port is ``gr4_packet_modem_tpu_torch.
bench``).

Each program runs as ``python -m gr4_packet_modem_tpu_torch.benchmarks.
benchmark_<name>`` with the positional command line of its JAX counterpart
plus ``--device`` (default ``cuda``; a missing card raises, nothing falls
back to the CPU). Each has ``run(argv=None, device="cuda", echo=True) ->
dict``: it builds the JAX program's stimulus with the port's own
transmitter, times the same step for the same number of calls, prints the
same JSON record under the same metric name (when ``echo``) and returns it.
``main()`` runs it on ``sys.argv``. Nothing runs at import.

- ``benchmark_packet_transmitter_pdu [stream|burst] [batch]``: the
  transmitter (no kernel);
- ``benchmark_syncword_detection [freq_bins] [backend] [block_log2]``:
  acquisition alone (``fft``, ``conv``, ``conv_bf16``: K2, K2b; ``fused``:
  K1 too; ``fused_bf16``: K1's bf16 form too);
- ``benchmark_packet_receiver [freq_bins] [channels] [block_log2]``: the
  bank's acquisition and ``Receiver.decode_bank`` (all six kernels);
- ``benchmark_packet_transceiver [freq_bins] [batch]``: TX -> ``rotate``
  -> ``awgn`` -> one-shot receive (all six kernels);
- ``benchmark_bank_scaling [channels_per_device] [block_log2]``:
  ``parallel/multihost.measure_scaling`` over the process group (a world
  of one started here when none is set up).

The baselines are the GR4 reference's rates on a Ryzen 7 5800X CPU
(results.md), as in the JAX programs: the yardstick of ``vs_baseline``,
not a number of the port.
"""

BENCHMARKS = (
    "benchmark_bank_scaling", "benchmark_packet_receiver", "benchmark_packet_transceiver",
    "benchmark_packet_transmitter_pdu", "benchmark_syncword_detection",
)
