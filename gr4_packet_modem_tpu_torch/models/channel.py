"""Channel impairment models (port of ``gr4_packet_modem_tpu/models/
channel.py``), used by the transceiver and the loopback checks
(apps/packet_transceiver.cpp:71-78, qa_loopback.cpp):

- ``rotate``: constant carrier frequency offset (rotator.hpp), a
  closed-form phase ramp. The phase of sample n is split as ``n = q*4096 +
  r`` with the block phase ``w*4096 mod 2*pi`` taken in float64 on the
  host, so float32 keeps its accuracy over long streams (a plain float32
  ``w * n`` is off by about 1e-3 rad at n = 6e5);
- ``awgn``: complex white Gaussian noise (noise_source.hpp) from an
  explicit ``torch.Generator`` on the samples' device;
- ``sfo``: sampling frequency offset through the polyphase arbitrary
  resampler (pfb_arb_resampler.hpp) with the reference's 32-arm
  Parks-McClellan prototype (pfb_arb_taps.hpp:8-12).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..ops.fir import pfb_arb_resample

__all__ = ["rotate", "awgn", "sfo", "esn0_db_to_noise_sigma", "pfb_arb_taps"]

_TWO_PI = 2.0 * math.pi


def _mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """Floor modulo as the JAX package computes it: the exact ``fmod``,
    then ``+ b`` where the sign differs from ``b`` (> 0)."""
    m = torch.fmod(a, b)
    return torch.where(m < 0, m + b, m)


def rotate(x: torch.Tensor, phase_incr: float, phase0: float = 0.0, n0: int = 0) -> torch.Tensor:
    """Frequency shift: ``y[n] = x[n] * exp(i*(phase0 + w*(n0 + n)))``
    along the last axis."""
    n = torch.arange(x.shape[-1], device=x.device) + n0
    w = float(phase_incr) % _TWO_PI
    w_block = (w * 4096.0) % _TWO_PI  # host float64
    q = torch.div(n, 4096, rounding_mode="floor")
    r = n - q * 4096
    two_pi32 = float(np.float32(_TWO_PI))
    ph = (
        _mod(q.to(torch.float32) * float(np.float32(w_block)), two_pi32)
        + r.to(torch.float32) * float(np.float32(w))
        + float(np.float32(phase0 % _TWO_PI))
    )
    return x * torch.complex(torch.cos(ph), torch.sin(ph))


def awgn(x: torch.Tensor, amplitude: float, generator: torch.Generator) -> torch.Tensor:
    """Add complex AWGN with per-component standard deviation ``amplitude``
    (noise_source.hpp: ``amplitude`` times unit-variance Gaussians on I and
    Q independently). ``generator`` lies on ``x``'s device."""
    noise = torch.randn(*x.shape, 2, generator=generator, device=x.device, dtype=torch.float32)
    return x + float(np.float32(amplitude)) * torch.view_as_complex(noise)


def esn0_db_to_noise_sigma(esn0_db: float, signal_power: float, sps: int = 4) -> float:
    """Per-component noise sigma for a target Es/N0, given the mean sample
    power of the modulated signal (apps/packet_transceiver.cpp:48-52)."""
    es = signal_power * sps  # energy per symbol at sps samples a symbol
    n0 = es / (10.0 ** (esn0_db / 10.0))
    return float(np.sqrt(n0 / 2.0))


@lru_cache(maxsize=1)
def pfb_arb_taps(num_arms: int = 32, taps_per_arm: int = 40) -> np.ndarray:
    """Prototype low-pass of the arbitrary resampler (pfb_arb_taps.hpp:8-12:
    Parks-McClellan, ``32*40`` taps, 0.45/32 passband, 0.55/32 stopband,
    stopband weight 10, gain x32), float32, read-only."""
    from scipy import signal

    taps = signal.remez(
        num_arms * taps_per_arm,
        [0.0, 0.45 / num_arms, 0.55 / num_arms, 0.5],
        [1.0, 0.0],
        weight=[1.0, 10.0],
        fs=1.0,
    )
    out = (taps * num_arms).astype(np.float32)
    out.flags.writeable = False
    return out


def sfo(x: torch.Tensor, ppm: float, num_out: int | None = None) -> torch.Tensor:
    """Sampling-frequency-offset impairment of a 1-D ``x``: resample by
    ``1 + ppm*1e-6``."""
    rate = 1.0 + ppm * 1e-6
    taps = pfb_arb_taps()
    diff = np.concatenate([taps[1:] - taps[:-1], [np.float32(0)]])
    n_out = num_out if num_out is not None else int(x.shape[-1] * rate)
    return pfb_arb_resample(x, rate, taps, diff, 32, n_out)
