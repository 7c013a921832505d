"""Polyphase FIR filters (port of ``gr4_packet_modem_tpu/ops/fir.py``:
``interpolating_fir``, ``stream_interpolating_fir``, ``pfb_symbol_filter``
and ``pfb_arb_resample``).

- ``interpolating_fir``: the TX pulse shaper (interpolating_fir_filter.hpp).
  Polyphase branch j of output symbol s is ``sum_k taps[j + I*k] *
  x[s - k]``, computed as one fused multiply-add over the whole batch per
  tap of an arm (12 for the modem's 45 taps at 4 samples a symbol), on the
  I/Q planes. Every product and sum is a float32 elementwise operation:
  no matmul or convolution, so no TF32 setting of cuBLAS or cuDNN changes
  the samples.
- ``pfb_symbol_filter``: the RX matched filter and decimator of one packet
  (symbol_filter.hpp) at a fixed polyphase arm: a plain slice of the
  samples, then one multiply-add per tap of the arm, elementwise as the TX
  FIR does. The receiver runs the batched form on the card as K2 and K3
  (``models/receiver.py::Receiver._extract_symbols``).
- ``pfb_arb_resample``: the channel model's arbitrary resampler
  (pfb_arb_resampler.hpp). Output sample times are known in closed form,
  so each output's arm, fractional weight and input window follow from its
  index; the window is gathered tap by tap from the input (``x[ip - j]``),
  never stacked as an ``[N, K]`` array.

Taps may be numpy arrays or float32 tensors; they are used on the device
of the samples.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["interpolating_fir", "stream_interpolating_fir", "pfb_symbol_filter", "pfb_arb_resample"]


def _polyphase(taps, branches: int, device) -> torch.Tensor:
    """``[K, branches]`` float32 on ``device``: element ``[k, j]`` is
    ``taps[j + branches*k]``, zero past the end (branch j is
    ``taps[j::branches]``)."""
    if not isinstance(taps, torch.Tensor):
        taps = torch.tensor(np.asarray(taps, np.float32))
    taps = taps.to(device=device, dtype=torch.float32)
    k = -(-taps.numel() // branches)
    tp = taps.new_zeros(k * branches)
    tp[: taps.numel()] = taps
    return tp.view(k, branches)


def _planes(x: torch.Tensor) -> torch.Tensor:
    """``[..., N]`` -> ``[..., N, 2]`` I/Q planes (complex) or ``[..., N, 1]``."""
    return torch.view_as_real(x) if x.is_complex() else x[..., None]


def _unplanes(y: torch.Tensor, cplx: bool) -> torch.Tensor:
    return torch.view_as_complex(y) if cplx else y[..., 0]


def interpolating_fir(symbols: torch.Tensor, taps, interpolation: int) -> torch.Tensor:
    """``[..., S]`` symbols -> ``[..., S*I]`` samples with zero initial
    history (each burst starts from a flushed filter)."""
    i = int(interpolation)
    tp = _polyphase(taps, i, symbols.device)  # [K, I]
    kk, s = tp.shape[0], symbols.shape[-1]
    x = _planes(symbols)  # [..., S, P]
    zeros = x.new_zeros(*x.shape[:-2], kk - 1, x.shape[-1])
    xp = torch.cat([zeros, x], dim=-2)  # xp[..., kk-1+s] = x[..., s]
    y = x.new_zeros(*x.shape[:-2], s, i, x.shape[-1])
    for k in range(kk):
        xk = xp[..., kk - 1 - k : kk - 1 - k + s, :]  # x[s - k]
        y.addcmul_(xk[..., :, None, :], tp[k][:, None])
    return _unplanes(y.reshape(*x.shape[:-2], s * i, x.shape[-1]), symbols.is_complex())


def stream_interpolating_fir(
    carry: torch.Tensor, symbols: torch.Tensor, taps, interpolation: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming variant: ``carry`` holds the previous ``K-1`` symbols
    (zeros at the start). Returns ``(new_carry, samples [..., S*I])``."""
    i = int(interpolation)
    kk = -(-len(taps) // i)
    x = torch.cat([carry, symbols], dim=-1)
    y = interpolating_fir(x, taps, i)[..., (kk - 1) * i :]
    return x[..., x.shape[-1] - (kk - 1) :], y


def pfb_symbol_filter(
    samples: torch.Tensor,
    start,
    arm,
    pfb_taps,
    num_arms: int,
    num_symbols: int,
    sps: int = 4,
) -> torch.Tensor:
    """Matched-filter and decimate one packet to 1 sample/symbol.

    ``samples``: the (frequency-corrected) sample buffer ``[N]``; ``start``:
    the sample at which symbol 0 is output (the newest history sample of
    the first inner product, symbol_filter.hpp:208-238); ``arm``: the
    polyphase arm of the fractional time estimate. ``start`` and ``arm``
    are ints or 0-d tensors. Output symbol s is ``sum_k taps[arm + A*k] *
    samples[start + sps*s - k]`` ``[num_symbols]``. The window's first
    sample is placed as ``lax.dynamic_slice`` places it: a negative one
    counts from the end, then it is clamped into the buffer."""
    n, a = samples.shape[0], int(num_arms)
    if not isinstance(pfb_taps, torch.Tensor):
        pfb_taps = torch.tensor(np.asarray(pfb_taps, np.float32))
    pfb_taps = pfb_taps.to(device=samples.device, dtype=torch.float32)
    kk = pfb_taps.shape[0] // a
    arm_taps = pfb_taps[int(arm) : int(arm) + a * kk : a]  # taps[arm + A*k]
    region_len = sps * (num_symbols - 1) + kk
    base = int(start) - (kk - 1)
    base = min(max(base + n if base < 0 else base, 0), n - region_len)
    xa = _planes(samples[base : base + region_len])  # [R, P]
    span = sps * (num_symbols - 1) + 1
    y = xa.new_zeros(num_symbols, xa.shape[-1])
    for k in range(kk):
        # xa[(kk-1) + sps*s - k] for every s
        y.addcmul_(xa[kk - 1 - k : kk - 1 - k + span : sps], arm_taps[k])
    return _unplanes(y, samples.is_complex())


def pfb_arb_resample(
    x: torch.Tensor,
    rate: float,
    taps,
    diff_taps,
    num_arms: int,
    num_out: int,
) -> torch.Tensor:
    """Polyphase arbitrary resampler with derivative-filter linear
    interpolation (pfb_arb_resampler.hpp:44-101) of a 1-D ``x``.

    Output k is input time ``t_k = k / rate``; with ``ip = floor(t_k)`` and
    arm position ``fa = (t_k - ip) * A``: ``y[k] = dot(taps[arm], win(ip))
    + frac * dot(diff_taps[arm], win(ip))``, ``arm = floor(fa)``, ``frac =
    fa - arm``, ``win(ip)[j] = x[ip - j]`` (zero before the start; ``ip``
    is clamped to the last input). The time base takes the JAX package's
    float32 steps: ``k * step`` split into an integer and a fractional
    part, plus ``k`` times the float32 residual of ``step``."""
    if x.ndim != 1:
        raise ValueError(f"pfb_arb_resample takes a 1-D signal, got {tuple(x.shape)}")
    a, n, dev = int(num_arms), x.shape[0], x.device
    tp = _polyphase(taps, a, dev).T  # [A, K]: tp[j, k] = taps[j + A*k]
    dtp = _polyphase(diff_taps, a, dev).T
    step = 1.0 / float(rate)
    step32 = np.float32(step)
    resid = np.float32(step - float(step32))
    kf = torch.arange(num_out, device=dev, dtype=torch.float32)
    prod = kf * float(step32)  # float32 products: both scalars are float32 values
    ti = torch.floor(prod)
    tf = prod - ti + kf * float(resid)
    ip = ti.to(torch.int64) + torch.floor(tf).to(torch.int64)
    fa = (tf - torch.floor(tf)) * a
    arm = torch.floor(fa).to(torch.int64).clamp(0, a - 1)
    frac = fa - arm.to(torch.float32)
    xp = _planes(x)  # [N, P]
    ip = ip.clamp(max=n - 1)
    y0 = xp.new_zeros(num_out, xp.shape[-1])
    y1 = torch.zeros_like(y0)
    for j in range(tp.shape[1]):
        idx = ip - j
        v = torch.where((idx >= 0)[:, None], xp[idx.clamp(min=0)], 0.0)
        y0 += v * tp[arm, j][:, None]
        y1 += v * dtp[arm, j][:, None]
    return _unplanes(y0 + frac[:, None] * y1, x.is_complex())
