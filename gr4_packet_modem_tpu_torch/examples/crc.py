"""CRC demo: the generic host CRC, the batched engine, and the append/check
pair (port of examples/crc.py; the reference's crc.cpp / crc_check.cpp /
crc_append_missing_tags.cpp).

usage: python -m gr4_packet_modem_tpu_torch.examples.crc [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.crc import BatchedCrcAppend, BatchedCrcCheck, CrcRef, make_crc32_engine
from . import check, parse

CRC16_CCITT = dict(num_bits=16, poly=0x1021, initial_value=0xFFFF, final_xor=0x0000,
                   input_reflected=False, result_reflected=False)


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns ``host`` (name -> CRC of b"123456789"), ``batched`` (the
    engine's hex CRCs of three rows) and ``crc_ok`` after corrupting
    packet 1."""
    _, dev = parse(argv, "crc")
    data = np.frombuffer(b"123456789", np.uint8)

    # generic host CRC, parameter-compatible with the reference Crc class
    host = {}
    for name, kw in [("CRC-32", {}), ("CRC-16/CCITT", CRC16_CCITT)]:
        host[name] = CrcRef(**kw).compute(data)
        echo(f"{name}: 0x{host[name]:08X}")

    # batched engine: many packets in one pass
    engine = make_crc32_engine(max_len=32)
    batch = torch.zeros((3, 32), dtype=torch.uint8, device=dev)
    batch[:, :9] = torch.tensor(data, device=dev)
    lengths = torch.as_tensor([9, 9, 5], device=dev)
    batched = [hex(int(v)) for v in engine.compute(batch, lengths).cpu()]
    echo(f"batched CRC-32: {batched}")

    # append -> corrupt one packet -> check
    with_crc, new_lens = BatchedCrcAppend(max_len=32).append(batch, lengths)
    with_crc = with_crc.clone()
    with_crc[1, 3] += 1  # corrupt packet 1
    ok, _stripped, _lens = BatchedCrcCheck(max_len=32 + 4).check(with_crc, new_lens)
    crc_ok = ok.cpu().tolist()
    echo(f"crc_ok after corrupting packet 1: {crc_ok}")
    check(crc_ok == [True, False, True], f"crc_ok {crc_ok}")
    return {"host": host, "batched": batched, "crc_ok": crc_ok}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
