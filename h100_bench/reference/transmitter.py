"""The plain reference transmitter and channel of the transceiver cell.

Plain PyTorch (numpy for each packet's frame bytes), written from
upstream's framing (packet_transmitter_pdu.hpp) with the frozen stimulus's
functions and tables beside it (``stimulus.py``, ``constants.py``,
``firdes.py``, ``lfsr.py``): it imports nothing of the program and runs no
hand-written kernel.

:class:`ReferenceTransmitter` makes a bank of C links with K packets each:

1. each packet's frame bytes (the header LDPC-coded and repeated, the
   payload, its CRC-32 by zlib: ``stimulus.frame_bytes``), their bits
   XORed with the additive scrambler's keystream from its start, mapped
   two bits a symbol to QPSK;
2. the burst's symbols: the BPSK syncword, the data, the 9 ramp-down QPSK
   symbols of the packet's 18 GLFSR bits, 11 zero flush symbols;
3. the RRC interpolation as a direct-form FIR over the zero-stuffed
   symbols, one multiply-add over the batch for each of the 45 taps in
   float32;
4. the lead ramp over the burst's first samples and the trail ramp over
   its last;
5. each link's bursts back to back from its offset in a block of zeros.

Departures from upstream, each one the program's too: the GLFSR index
wraps every ``max_packets_glfsr`` (4096) packets, where upstream's
degree-32 GLFSR runs on for 2**32 - 1 bits (the bits only fill the
ramp-down, which no receiver decodes); bursts past the block are cut.

:func:`channel`: each link's samples times ``exp(i (phase + w n))``, the
phase in float64 and the product in complex128, rounded to complex64,
between the receiver's zero pads; then complex AWGN over the whole bank,
pads too (upstream's noise source runs on every sample), drawn by the
call the program makes (``torch.randn(C, front_pad + block + pad_tail,
2)`` on its device, from a generator set to the state the program's had
before the call) times the amplitude in float32.

``dtype`` computes the FIR, the ramps and the rotated samples in a lower
precision than float32 (``torch.bfloat16``), for the control reading of
the limits.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from . import constants as C
from .firdes import tx_rrc_taps
from .lfsr import additive_scrambler_keystream, glfsr_bits
from .stimulus import burst_ramps, frame_bytes

__all__ = ["ReferenceTransmitter", "channel"]


@lru_cache(maxsize=16)
def _keystream(num_bits: int) -> np.ndarray:
    return additive_scrambler_keystream(num_bits)


@lru_cache(maxsize=2)
def _ramp_bits(max_packets: int) -> np.ndarray:
    """uint8 ``[max_packets, 18]``: packet p's ramp-down bits."""
    return glfsr_bits(C.RAMP_DOWN_BITS * max_packets).reshape(max_packets, C.RAMP_DOWN_BITS)


def _qpsk(bits: np.ndarray) -> np.ndarray:
    return np.asarray(C.QPSK_CONSTELLATION)[bits.reshape(-1, 2) @ np.array([2, 1])]


class ReferenceTransmitter:
    """Burst-mode TX of a bank on ``device``."""

    def __init__(self, device: torch.device, sps: int = 4, max_packets_glfsr: int = 4096,
                 dtype: torch.dtype = torch.float32):
        self.device, self.sps, self.max_packets, self.dtype = device, int(sps), int(max_packets_glfsr), dtype
        self.taps = [float(t) for t in tx_rrc_taps(self.sps)]
        lead, trail = burst_ramps(self.sps)
        self.lead = torch.from_numpy(lead).to(device, dtype)
        self.trail = torch.from_numpy(trail).to(device, dtype)

    @staticmethod
    def data_symbols(payload: np.ndarray) -> np.ndarray:
        """The scrambled QPSK symbols of one user packet's frame."""
        bits = np.unpackbits(frame_bytes(payload))
        return _qpsk(bits ^ _keystream(bits.size))

    def burst_symbols(self, frames: list[np.ndarray], packet_index: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
        """Each packet's burst symbols from its data symbols (``frames``)
        and its GLFSR index: complex64 ``[B, longest]`` on the device,
        zeros past each burst, and the bursts' lengths."""
        sync = np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)]
        flush = np.zeros(C.RRC_FLUSH_SYMBOLS, np.complex64)
        ramps = _ramp_bits(self.max_packets)
        bursts = [np.concatenate([sync, f, _qpsk(ramps[int(p) % self.max_packets]), flush])
                  for f, p in zip(frames, packet_index)]
        lens = np.array([b.size for b in bursts])
        out = np.zeros((len(bursts), lens.max()), np.complex64)
        for i, b in enumerate(bursts):
            out[i, : b.size] = b
        return torch.from_numpy(out).to(self.device), lens

    def bursts(self, symbols: torch.Tensor, lens: np.ndarray) -> torch.Tensor:
        """Shaped samples ``[B, longest * sps]`` of :meth:`burst_symbols`."""
        b, s = symbols.shape
        n = s * self.sps
        u = torch.zeros(b, n, 2, dtype=self.dtype, device=self.device)
        u[:, :: self.sps] = torch.view_as_real(symbols).to(self.dtype)
        y = torch.zeros_like(u)
        for t, tap in enumerate(self.taps):  # y[n] += taps[t] * u[n - t]
            y[:, t:] += tap * u[:, : n - t]
        nl, tl = self.lead.numel(), self.trail.numel()
        y[:, :nl] *= self.lead[:, None]
        for length in np.unique(lens):  # the trail ramp ends at each burst's end
            rows = torch.from_numpy(np.nonzero(lens == length)[0]).to(self.device)
            end = int(length) * self.sps
            y[rows, end - tl : end] *= self.trail[:, None]
            y[rows, end:] = 0
        return torch.view_as_complex(y.float().contiguous())

    def bank(self, frames: list[list[np.ndarray]], packet_index: np.ndarray, offset: np.ndarray,
             block: int) -> torch.Tensor:
        """The TX bank ``[C, block]`` complex64: link c's packets (data
        symbols ``frames[c]``), packet k at GLFSR index ``packet_index[c]
        + k``, back to back from sample ``offset[c]``."""
        c = len(frames)
        flat = [f for row in frames for f in row]
        index = np.concatenate([int(packet_index[i]) + np.arange(len(row)) for i, row in enumerate(frames)])
        symbols, lens = self.burst_symbols(flat, index)
        samples = self.bursts(symbols, lens)
        out = torch.zeros(c, block, dtype=torch.complex64, device=self.device)
        j = 0
        for i, row in enumerate(frames):
            pos = int(offset[i])
            for _ in row:
                n = max(0, min(int(lens[j]) * self.sps, block - pos))
                out[i, pos : pos + n] = samples[j, :n]
                pos += int(lens[j]) * self.sps
                j += 1
        return out


def channel(x: torch.Tensor, cfo: np.ndarray, phase: np.ndarray, noise: float, generator_state: torch.Tensor,
            front_pad: int, pad_tail: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The received bank ``[C, front_pad + block + pad_tail]`` of the TX
    bank ``x`` ``[C, block]``: link c rotated by ``cfo[c]`` rad/sample
    from ``phase[c]``, then AWGN of ``noise`` a component from a
    generator on ``x``'s device set to ``generator_state``, over the whole
    bank."""
    c, block = x.shape
    dev = x.device
    n = torch.arange(block, dtype=torch.float64, device=dev)
    ph = torch.from_numpy(np.asarray(phase, np.float64)).to(dev)[:, None] + \
        torch.from_numpy(np.asarray(cfo, np.float64)).to(dev)[:, None] * n
    y = (x.to(torch.complex128) * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)
    del ph
    if dtype != torch.float32:
        y = torch.view_as_complex(torch.view_as_real(y).to(dtype).float().contiguous())
    padded = torch.zeros(c, front_pad + block + pad_tail, dtype=torch.complex64, device=dev)
    padded[:, front_pad : front_pad + block] = y
    g = torch.Generator(device=dev)
    g.set_state(generator_state)
    z = torch.randn(*padded.shape, 2, generator=g, device=dev, dtype=torch.float32)
    return padded + float(np.float32(noise)) * torch.view_as_complex(z)
