"""Header format -> FEC encode -> decode -> parse round trip (port of
examples/header_formatter.py; the reference's header_formatter.cpp and the
qa_header_formatter golden vector): metadata {packet_length: 1234} formats
to the header 0x04 0xd2 0x00 0x55, which rate-1/8 LDPC-encodes to 32 bytes
and survives decode and parse with flipped bits. On CUDA tensors the decode
launches the header LDPC kernel (K5).

usage: python -m gr4_packet_modem_tpu_torch.examples.header_formatter [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ldpc
from ..ops.packing import pack_bits, unpack_bits
from ..utils import constants as C
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``header`` bytes, the ``coded`` bit count, the decoded
    ``bits`` and ``ok`` flags (numpy), and the parsed ``length`` and
    ``type``."""
    _, dev = parse(argv, "header_formatter")
    header = C.format_header(1234, int(C.PacketType.USER_DATA))
    echo(f"header bytes: {[hex(b) for b in header]}")  # 0x4 0xd2 0x0 0x55
    check(list(header) == [0x04, 0xD2, 0x00, 0x55], f"header {list(header)}")

    bits = unpack_bits(torch.as_tensor(header, device=dev), 8)[None]  # [1, 32]
    coded = ldpc.encode_header(bits).cpu().numpy()  # [1, 256]
    echo(f"coded bits: {coded.size} (= 4 B * 8 * rate 1/8)")

    # soft demod at perfect SNR, flip a few bits, decode
    llrs = (1.0 - 2.0 * coded.astype(np.float32)) * 4.0
    llrs[0, [7, 40, 200]] *= -1.0
    comb = ldpc.combine_repetition(torch.as_tensor(llrs, device=dev))
    info_bits, ok = ldpc.HeaderLdpcDecoder(25, device=dev).decode(comb)
    parsed = pack_bits(info_bits, 8).cpu().numpy()[0]
    ok = ok.cpu().numpy()
    length = int(parsed[0]) << 8 | int(parsed[1])
    echo(f"ldpc ok={bool(ok[0])} parsed length={length} type={int(parsed[2])}")
    check(bool(ok[0]) and length == 1234, f"ok={bool(ok[0])} length={length}")
    echo("header round trip ok")
    return {"header": header, "coded": int(coded.size), "bits": info_bits.cpu().numpy(),
            "ok": ok, "length": length, "type": int(parsed[2])}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
