"""The modem's apps on the PyTorch port (ports of ``apps/*.py``).

Each app runs as ``python -m gr4_packet_modem_tpu_torch.apps.<name>`` with
the command line of its JAX counterpart plus ``--device`` (default
``cuda``; a missing card raises, nothing falls back to the CPU). Each has
``run(argv=None, ..., echo=print) -> dict``: it does what the app does,
prints what the JAX app prints through ``echo``, and returns what it sent
and decoded, so a caller can drive it in its own process. ``main()`` runs
it on ``sys.argv``. Nothing runs at import.

- ``packet_transmitter_pdu``: packets -> transmitter -> raw complex64 file;
- ``packet_receiver_file``: raw complex64 file -> receiver -> TUN or stdout;
- ``packet_transmitter_pdu_throttle``: transmitter -> throttle -> rate probe;
- ``packet_transmitter_sdr``: TUN -> transmitter -> file or FIFO;
- ``packet_receiver_soapy``: SoapySDR device -> receiver -> TUN;
- ``packet_transceiver``: TUN -> transmitter -> channel model -> receiver
  -> TUN, the IP-over-radio serving path (a self-test loopback without
  TUN devices).

``io/tun.py::TunDevice`` needs CAP_NET_ADMIN (root); without ``--tun*``
options no app opens one.
"""

from __future__ import annotations

__all__ = ["split_device_arg"]


def split_device_arg(argv: list[str], default: str = "cuda") -> tuple[list[str], str]:
    """Take ``--device DEV`` (or ``--device=DEV``) out of a positional
    command line. Returns ``(the other arguments, DEV)``."""
    rest, device = [], default
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it, None)
            if device is None:
                raise SystemExit("--device needs a value")
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            rest.append(a)
    return rest, device
