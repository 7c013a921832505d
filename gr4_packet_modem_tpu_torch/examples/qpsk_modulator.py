"""Registry-style composition: bytes -> unpacked bits -> QPSK symbols, the
blocks resolved by their reference names through the port's registry (port
of examples/qpsk_modulator.py; the reference's
python/examples/qpsk_modulator.py).

usage: python -m gr4_packet_modem_tpu_torch.examples.qpsk_modulator [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from .. import registry
from ..utils.constants import QPSK_CONSTELLATION
from . import parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``symbols`` (numpy complex64 ``[16]``)."""
    _, dev = parse(argv, "qpsk_modulator")
    unpack = registry.resolve("UnpackBits")
    mapper = registry.resolve("Mapper")

    data = torch.tensor(np.frombuffer(b"\x11\x22\x33\x44", np.uint8), device=dev)[None]
    bits = unpack(data, 8)
    symbol_idx = registry.resolve("PackBits")(bits, 2)
    constellation = torch.as_tensor(QPSK_CONSTELLATION.astype(np.complex64), device=dev)
    symbols = mapper(symbol_idx, constellation).cpu().numpy().astype(np.complex64)[0]
    echo(str(symbols))
    return {"symbols": symbols}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
