"""Raw file / FIFO sample and packet IO (a copy of
``gr4_packet_modem_tpu/io/file.py``: numpy only).

Equivalents of FileSource/FileSink (file_source.hpp, file_sink.hpp): raw
binary item streams, usable with mkfifo FIFOs to bridge to GNU Radio 3 / UHD
flowgraphs exactly like the reference apps (apps/README.md
packet_transmitter_sdr path).
"""

from __future__ import annotations

import numpy as np

__all__ = ["read_c64", "write_c64", "stream_c64_blocks", "FileSinkC64"]


def read_c64(path: str, max_items: int | None = None) -> np.ndarray:
    """Read a raw complex64 sample file (GR 'complex' format)."""
    count = -1 if max_items is None else max_items
    return np.fromfile(path, dtype=np.complex64, count=count)


def write_c64(path: str, samples: np.ndarray) -> None:
    np.asarray(samples, np.complex64).tofile(path)


def stream_c64_blocks(path: str, block: int):
    """Yield successive complex64 blocks from a file or FIFO."""
    item = np.dtype(np.complex64).itemsize
    with open(path, "rb", buffering=0) as f:
        while True:
            buf = f.read(block * item)
            if not buf:
                return
            n = len(buf) // item
            if n:
                yield np.frombuffer(buf[: n * item], np.complex64)


class FileSinkC64:
    """Streaming complex64 sample sink (file or FIFO)."""

    def __init__(self, path: str):
        self._f = open(path, "wb", buffering=0)

    def write(self, samples: np.ndarray) -> None:
        self._f.write(np.asarray(samples, np.complex64).tobytes())

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
