"""Header path round trip: format -> rate-1/8 LDPC encode -> soft decode ->
parse, with one header corrupted beyond repair (port of
examples/header_roundtrip.py; the reference's header_formatter.cpp and the
HeaderFecEncoder / HeaderFecDecoder / HeaderParser chain). The LLR noise is
numpy's, as in the JAX example; on CUDA tensors the decode launches the
header LDPC kernel (K5).

usage: python -m gr4_packet_modem_tpu_torch.examples.header_roundtrip [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import ldpc
from ..ops.packing import bytes_to_bits, pack_bits
from . import check, parse


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the decoded ``bits`` and ``ok`` flags (numpy) and the
    ``parsed`` (length, type) of each valid header (None for a failed
    one)."""
    _, dev = parse(argv, "header_roundtrip")
    # format headers for three packets (u16 BE length, type, 0x55 spare)
    lengths = [1234, 64, 4096]
    headers = np.array([[ln >> 8, ln & 0xFF, 0x00, 0x55] for ln in lengths], np.uint8)
    echo(f"headers: {[bytes(h).hex() for h in headers]}")

    bits = bytes_to_bits(torch.as_tensor(headers, device=dev))  # [B, 32] MSB-first
    coded = ldpc.encode_header(bits)  # [B, 256] incl. repeat

    # BPSK LLRs at ~2 dB, with header 1 hit by gross noise
    rng = np.random.default_rng(0)
    llr = 4.0 * (1.0 - 2.0 * coded.cpu().numpy().astype(np.float32))
    llr += 2.5 * rng.standard_normal(llr.shape).astype(np.float32)
    llr[1] = rng.standard_normal(256).astype(np.float32) * 8.0

    comb = ldpc.combine_repetition(torch.as_tensor(llr, device=dev))
    dec_bits, ok = ldpc.HeaderLdpcDecoder(25, device=dev).decode(comb)
    out = pack_bits(dec_bits, 8).cpu().numpy()
    ok = ok.cpu().numpy()
    parsed = []
    for i, (h, flag) in enumerate(zip(out, ok)):
        if not flag:
            echo(f"header {i}: invalid_header (LDPC failure)")  # header_parser.hpp:61-83
            parsed.append(None)
            continue
        parsed.append((int(h[0]) << 8 | int(h[1]), int(h[2])))
        echo(f"header {i}: packet_length={int(h[0]) << 8 | int(h[1])} "
             f"type={'user_data' if h[2] == 0 else 'idle'}")
    check(list(ok) == [True, False, True], f"ok flags {list(ok)}")
    return {"bits": dec_bits.cpu().numpy(), "ok": ok, "parsed": parsed}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
