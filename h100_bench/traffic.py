"""The one traffic generator: every mix is a data file of parameters
(``traffic/<name>.json``) that this module reads.

All traffic comes from ``--seed``. The payloads and every random choice
are drawn with numpy from the seed; the bursts are built once by the frozen
stimulus (``reference/stimulus.py``, never the program's transmitter); the
samples are laid out, rotated and noised on the device with a
``torch.Generator`` seeded from the seed, in a few large calls. Every seed
gets the same sizes (channels, packets, lengths); only contents, order,
offsets, CFO, phase and noise change.

The keys of a mix:

- ``entry``: the driver in ``entries/`` that feeds it;
- ``channels``: channels of the bank;
- ``blocks``: distinct blocks a resident mix stages on the card, or the
  blocks of one cycle of a host-fed stream;
- ``payload_len``, ``pool``: a pool of ``pool`` distinct random payloads
  of ``payload_len`` bytes, laid back to back on every channel in an order
  drawn from the seed, from a random offset per channel;
- ``cfo``: each channel's carrier offset is uniform in ``[-cfo, cfo]``
  rad/sample, its phase uniform;
- ``noise``: AWGN standard deviation a component;
- ``adc_scale`` (host-fed): the samples are quantised to this fixed point
  and clipped to 8 bits, as an SDR front end delivers them;
- ``transfer`` (host-fed): the streaming driver's wire type.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import stimulus

def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one use of the seed (any non-negative int)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def torch_generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


@dataclass
class Pool:
    payloads: np.ndarray  # uint8 [P, L]
    bursts: torch.Tensor  # complex64 [P, burst_len] on the device

    @property
    def burst_len(self) -> int:
        return self.bursts.shape[1]


def make_pool(seed: int, mix: dict, device: torch.device) -> Pool:
    """``pool`` distinct payloads of ``payload_len`` random bytes and their
    bursts (packet index = pool index, which picks the ramp-down bits)."""
    rng = rng_for(seed, 1)
    n, length = int(mix["pool"]), int(mix["payload_len"])
    payloads = rng.integers(0, 256, (n, length), dtype=np.uint8)
    bursts = np.stack([stimulus.burst_samples(p, i) for i, p in enumerate(payloads)])
    return Pool(payloads, torch.from_numpy(bursts).to(device))


@dataclass
class Layout:
    """Where each channel's packets lie: packet ``k`` of channel ``c`` is
    pool entry ``order[c, k]`` and starts at ``offset[c] + (k - 1) *
    burst_len`` (packet 0 starts before the span and is cut)."""

    order: np.ndarray   # int [C, K]
    offset: np.ndarray  # int [C], in [0, burst_len)
    cfo: np.ndarray     # float64 [C] rad/sample
    phase: np.ndarray   # float64 [C]

    def starts(self, burst_len: int) -> np.ndarray:
        k = np.arange(self.order.shape[1])
        return self.offset[:, None] + (k[None, :] - 1) * burst_len


def make_layout(rng: np.random.Generator, channels: int, span: int, pool: Pool, cfo: float,
                circular: bool = False) -> Layout:
    """Back-to-back packets over ``span`` samples a channel. A circular
    layout (one cycle of a stream) holds ``span // burst_len`` whole packets
    and wraps; its CFO is rounded to whole turns a cycle so that the cycle
    repeats without a phase step."""
    bl = pool.burst_len
    k = span // bl if circular else -(-span // bl) + 2
    order = rng.integers(0, len(pool.payloads), (channels, k))
    offset = rng.integers(0, bl, channels)
    f = rng.uniform(-cfo, cfo, channels)
    if circular:
        f = np.round(f * span / (2 * np.pi)) * 2 * np.pi / span
    phase = rng.uniform(-np.pi, np.pi, channels)
    if circular:  # the layout's packet 0 then starts at the offset
        offset = offset + bl
    return Layout(order, offset, f, phase)


def synthesize(layout: Layout, pool: Pool, span: int, noise: float, gen: torch.Generator,
               circular: bool = False) -> torch.Tensor:
    """The channels' samples ``[C, span]`` complex64 on the pool's device:
    the bursts in the layout, each channel rotated by its CFO and phase,
    plus complex Gaussian noise of ``noise`` a component."""
    dev = pool.bursts.device
    c, k = layout.order.shape
    bl = pool.burst_len
    order = torch.from_numpy(layout.order).to(dev)
    train = pool.bursts[order].reshape(c, k * bl)  # each channel from its packet 0
    t = torch.arange(span, device=dev)
    first = torch.from_numpy(layout.offset - bl).to(dev)  # start of packet 0
    pos = t[None, :] - first[:, None]
    if circular:
        pos = torch.remainder(pos, span)
    inside = (pos >= 0) & (pos < k * bl)
    x = torch.where(inside, train.gather(1, pos.clamp(0, k * bl - 1)), 0)
    del train, pos, inside
    ang = (torch.from_numpy(layout.cfo).to(dev)[:, None] * t[None, :].double()
           + torch.from_numpy(layout.phase).to(dev)[:, None])
    x = x * torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    del ang
    z = torch.randn(c, span, 2, generator=gen, device=dev) * noise
    return x + torch.view_as_complex(z)


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """Samples on the fixed-point grid ``1/scale``, clipped to 8 bits."""
    q = torch.view_as_real(x).mul(scale).round().clamp(-127, 127).div(scale)
    return torch.view_as_complex(q.contiguous())


def truth(layout: Layout, pool: Pool, span: int, circular: bool = False) -> list[list[tuple[int, int, bool]]]:
    """Per channel, the ``(start, pool id, whole)`` of every packet whose
    burst overlaps ``[0, span)``; ``whole`` marks those that lie wholly in
    the span and so must decode (a packet cut only in its ramps may decode
    too). A circular layout's packets are all whole."""
    bl = pool.burst_len
    starts = layout.starts(bl)
    out = []
    for c in range(starts.shape[0]):
        row = []
        for s, p in zip(starts[c], layout.order[c]):
            if circular:
                row.append((int(s % span), int(p), True))
            elif -bl < s < span:
                row.append((int(s), int(p), bool(0 <= s and s + bl <= span)))
        out.append(row)
    return out
