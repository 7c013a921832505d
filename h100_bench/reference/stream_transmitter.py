"""The plain reference stream-mode transmitter and channel of the stream
transceiver cell.

Plain PyTorch (numpy for each packet's frame bytes), written from
upstream's stream mode (packet_transmitter_pdu.hpp in stream mode:
``symbols_mux`` -> ``PduToTaggedStream`` -> ``InterpolatingFirFilter``, no
burst shaper, no ramp-down, no flush symbols; apps/packet_transceiver.cpp
``--stream``) with the frozen stimulus's functions and tables beside it;
it imports nothing of the program and runs no hand-written kernel.

:class:`ReferenceStreamTransmitter` makes one step's samples of a bank of
C links from each link's packets counted from the start of its stream,
never from state carried over from an earlier step:

1. each packet's symbols: the BPSK syncword, then its frame (header with
   its type, payload, CRC-32) scrambled from its start and mapped to QPSK
   (``stimulus.data_symbols``);
2. the link's symbols of the step, and the ``arm_len - 1`` before them
   that the filter still holds, placed from each packet's start symbol
   (zeros before the stream's first symbol);
3. the RRC interpolation as a direct-form FIR over the zero-stuffed
   symbols, one multiply-add over the bank for each of the taps in
   float32.

Departures from upstream, each one the program's too: a packet's symbols
follow the last one's with no gap, where upstream's TUN source waits for a
packet or an IDLE fill; every link starts its stream with zero history at
the bank's first step.

:func:`stream_channel`: each link's samples of step ``i`` times ``exp(i
(phase0 + cfo (i * block + n)))``, the phase computed in float64 from the
stream's start and the product in complex128, rounded to complex64; then
complex AWGN over the block, drawn by the call the program makes
(``torch.randn(C, block, 2)`` on its device, from a generator set to the
state the program's had before the call) times the amplitude in float32.

``dtype`` computes the FIR and the rotated samples in a lower precision
than float32 (``torch.bfloat16``), for the control reading of the limits.
"""

from __future__ import annotations

import numpy as np
import torch

from . import constants as C
from .firdes import tx_rrc_taps
from .stimulus import data_symbols

__all__ = ["ReferenceStreamTransmitter", "stream_channel"]


class ReferenceStreamTransmitter:
    """Stream-mode TX of a bank on ``device``."""

    def __init__(self, device: torch.device, sps: int = 4, dtype: torch.dtype = torch.float32):
        self.device, self.sps, self.dtype = device, int(sps), dtype
        self.taps = [float(t) for t in tx_rrc_taps(self.sps)]
        self.history = -(-len(self.taps) // self.sps) - 1  # symbols the filter holds

    @staticmethod
    def packet_symbols(payload: np.ndarray, packet_type: int) -> np.ndarray:
        """One packet's stream symbols: syncword, then its scrambled frame."""
        sync = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
        return np.concatenate([sync, data_symbols(payload, packet_type)]).astype(np.complex64)

    def block(self, links: list[list[tuple[int, np.ndarray]]], step: int, block: int) -> torch.Tensor:
        """Samples ``[C, block]`` complex64 of step ``step``: link c's
        packets ``links[c]``, each ``(start symbol from the stream's start,
        its symbols)``, every packet that overlaps the step's symbols or the
        filter's history before them."""
        s = block // self.sps
        lo, hi = step * s - self.history, (step + 1) * s
        syms = np.zeros((len(links), hi - lo), np.complex64)
        for c, packets in enumerate(links):
            for start, sym in packets:
                a, b = max(start, lo, 0), min(start + sym.size, hi)
                if a < b:
                    syms[c, a - lo : b - lo] = sym[a - start : b - start]
        x = torch.from_numpy(syms).to(self.device)
        n = x.shape[1] * self.sps
        u = torch.zeros(x.shape[0], n, 2, dtype=self.dtype, device=self.device)
        u[:, :: self.sps] = torch.view_as_real(x).to(self.dtype)
        del x
        y = torch.zeros_like(u)
        for t, tap in enumerate(self.taps):  # y[n] += taps[t] * u[n - t]
            y[:, t:] += tap * u[:, : n - t]
        del u
        return torch.view_as_complex(y[:, self.history * self.sps :].float().contiguous())


def stream_channel(x: torch.Tensor, cfo: np.ndarray, phase0: np.ndarray, step: int, noise: float,
                   generator_state: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The received block ``[C, block]`` of step ``step``'s TX block ``x``:
    link c rotated by ``cfo[c]`` rad/sample from its phase at the stream's
    start ``phase0[c]``, then AWGN of ``noise`` a component from a
    generator on ``x``'s device set to ``generator_state``."""
    c, block = x.shape
    dev = x.device
    n = torch.arange(block, dtype=torch.float64, device=dev) + float(step) * block
    ph = torch.from_numpy(np.asarray(phase0, np.float64)).to(dev)[:, None] + \
        torch.from_numpy(np.asarray(cfo, np.float64)).to(dev)[:, None] * n
    y = (x.to(torch.complex128) * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)
    del ph
    if dtype != torch.float32:
        y = torch.view_as_complex(torch.view_as_real(y).to(dtype).float().contiguous())
    g = torch.Generator(device=dev)
    g.set_state(generator_state)
    z = torch.randn(c, block, 2, generator=g, device=dev, dtype=torch.float32)
    return y + float(np.float32(noise)) * torch.view_as_complex(z)
