"""Acquisition: detect a burst under CFO and noise and print the estimated
amplitude, frequency, timing and Es/N0 beside the truth (port of
examples/syncword_detection.py; the reference's syncword_detection.cpp).
On CUDA tensors acquisition runs the fused correlator (K1) and the
neighbour-power row fetch (K2b).

usage: python -m gr4_packet_modem_tpu_torch.examples.syncword_detection [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.channel import awgn, rotate
from ..models.receiver import Receiver, RxConfig
from ..models.transmitter import Transmitter, TxConfig
from ..utils.ragged import PacketBatch
from . import check, parse

CFO = 0.004  # rad/sample
GAP = 3000


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the truth (``gap``, ``cfo``) and the detection's ``start``,
    ``freq``, ``amp``, ``time_est`` and ``esn0_db``."""
    _, dev = parse(argv, "syncword_detection")
    tx = Transmitter(TxConfig(max_payload_len=64), dev)
    rng = np.random.default_rng(1)
    batch = PacketBatch.from_list([rng.integers(0, 256, 48, dtype=np.uint8)], 64, dev)
    bursts, lens = tx.modulate_bursts(batch)
    burst = bursts[0, : int(lens[0])].cpu().numpy()

    rx = Receiver(RxConfig(max_payload_len=64, max_detections=4), dev)
    x = np.zeros(rx.front_pad + GAP + burst.size + rx.pad_tail(), np.complex64)
    x[rx.front_pad + GAP : rx.front_pad + GAP + burst.size] = burst
    gen = torch.Generator(device=dev).manual_seed(0)
    x = awgn(rotate(torch.as_tensor(x, device=dev), CFO), 0.05, gen)

    det = rx.acquirer.acquire(x)
    valid = det.valid.cpu().numpy()
    i = int(np.argmax(valid))
    check(bool(valid[i]), "no detection")
    out = {
        "gap": GAP, "cfo": CFO,
        "start": int(det.index[i]) - rx.front_pad,
        "freq": float(det.freq[i]),
        "amp": float(det.amplitude[i]),
        "time_est": float(det.time_est[i]),
        "esn0_db": float(det.esn0_db[i]),
    }
    echo(f"truth:    start={GAP}  freq={CFO:+.5f} rad/sample")
    echo(f"detected: start={out['start']}  freq={out['freq']:+.5f}  amp={out['amp']:.3f}"
         f"  time_est={out['time_est']:+.3f}  esn0={out['esn0_db']:.1f} dB")
    return out


def main() -> None:
    run()


if __name__ == "__main__":
    main()
