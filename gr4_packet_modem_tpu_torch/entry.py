"""Entry points of the port: the counterparts of ``__graft_entry__.entry()``.

:func:`entry` returns the single-channel receive step (acquire -> header
decode -> overlap filter -> payload decode) and an example input;
:func:`bank_entry` returns the bank step at the bench geometry (64 channels
of 2**19 samples, 9 frequency bins, 1536-byte payloads, 24 detection slots,
V&V payload carrier, fused acquisition: bench.py's default backend).
"""

from __future__ import annotations

import torch

from .models.receiver import Receiver, RxConfig

__all__ = ["entry", "bank_entry", "BENCH_CONFIG", "BENCH_CHANNELS", "BENCH_BLOCK"]

# bench.py's geometry: max_detections is its formula for 12 x 1500-byte
# bursts tiled over a 2**19-sample block (bench.py:84-87)
BENCH_CHANNELS = 64
BENCH_BLOCK = 1 << 19
BENCH_CONFIG = RxConfig(
    max_payload_len=1536,
    max_detections=24,
    freq_bins=4,
    payload_carrier="vv",
    acquisition_backend="fused",
)


def entry(device: str | torch.device):
    """``(fn, example_args)`` for the single-channel step over one padded
    block of 2**16 samples; ``fn`` returns ``(accepted, lengths, data)``."""
    dev = torch.device(device)
    rx = Receiver(RxConfig(max_payload_len=256, max_detections=16, freq_bins=4), dev)

    def rx_step(samples: torch.Tensor):
        det = rx.acquirer.acquire(samples)
        hdr, _ = rx.decode_headers(samples, det)
        keep = rx.filter_detections(det, hdr)
        res = rx.decode_payloads(samples, det, hdr, keep)
        return res.accepted, res.lengths, res.data

    t = 1 << 16
    example = (
        torch.zeros(t + rx.front_pad + rx.pad_tail(), dtype=torch.complex64, device=dev),
    )
    return rx_step, example


def bank_entry(
    device: str | torch.device,
    channels: int = BENCH_CHANNELS,
    block: int = BENCH_BLOCK,
):
    """``(fn, example_args)`` for the bank step at the bench geometry;
    ``fn`` maps a padded bank ``[channels, front_pad + block + pad_tail]``
    to ``(det, hdr, res, keep)`` (``Receiver.bank_step``). ``channels`` and
    ``block`` may be cut for small runs."""
    dev = torch.device(device)
    rx = Receiver(BENCH_CONFIG, dev)
    n = rx.front_pad + block + rx.pad_tail()
    example = (torch.zeros(channels, n, dtype=torch.complex64, device=dev),)
    return rx.bank_step, example
