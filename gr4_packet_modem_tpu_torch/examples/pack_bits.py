"""Bit packing and unpacking: bytes -> bits -> QPSK symbol indices -> bytes
(port of examples/pack_bits.py; the reference's pack_bits.cpp).

usage: python -m gr4_packet_modem_tpu_torch.examples.pack_bits [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.packing import pack_bits, unpack_bits
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``bits``, the QPSK indices ``qpsk_idx`` and the bytes
    after the round trip ``round_trip``."""
    _, dev = parse(argv, "pack_bits")
    data = np.frombuffer(b"packet-modem", np.uint8)
    echo(f"bytes   : {data.tolist()}")

    bits = unpack_bits(torch.tensor(data, device=dev), 8)  # [N*8] MSB-first
    bits_np = bits.cpu().numpy()
    echo(f"bits    : {''.join(map(str, bits_np[:16].tolist()))} ...")

    qpsk_idx = pack_bits(bits, 2)  # 2 bits -> 1 index
    idx_np = qpsk_idx.cpu().numpy()
    echo(f"qpsk idx: {idx_np[:8].tolist()} ...")

    # round trip: indices -> bits -> bytes
    bits_rt = unpack_bits(qpsk_idx, 2)
    data_rt = pack_bits(bits_rt, 8).cpu().numpy().astype(np.uint8)
    check(data_rt.tobytes() == b"packet-modem", f"round trip {data_rt.tobytes()!r}")
    echo(f"round trip ok: {data_rt.tobytes()}")
    return {"bits": bits_np, "qpsk_idx": idx_np, "round_trip": data_rt.tobytes()}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
