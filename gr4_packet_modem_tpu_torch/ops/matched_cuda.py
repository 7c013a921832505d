"""K3: the per-detection matched filter on the card (``csrc/matched.cu``),
and the receiver's symbol extraction built around it.

Counterpart of ``gr4_packet_modem_tpu/ops/matched_pallas.py::
matched_filter_pallas``: filter each detection's region with its own
time-reversed taps and decimate by ``sps``,
``out[d, s] = sum_k z[d, sps*s + k] * taps[d, k]``, reading zeros past the
region's end. :func:`matched_filter` launches the kernel for CUDA tensors
and runs :func:`matched_filter_plain` for CPU tensors.

The kernel sums each output over the phases ``p < sps`` and, within a
phase, over ``q`` (tap ``k = sps*q + p``); ``tests/test_torch_kernel_models.py``
holds a numpy model of that order against the plain version.

:func:`extract_symbols` is the receiver's whole extraction (region fetch,
derotation, the filter at each row's polyphase arm, amplitude scaling,
chunk by chunk). On CUDA tensors it is one launch of the same kernel
reading the complex64 bank itself (``pm_extract_symbols``), counted in
``rx.extract.fused_rows``; on CPU tensors it runs
:func:`extract_symbols_plain`, K2's and K3's plain versions with the
derotation between them. Given K2's and K3's wrappers in their place,
:func:`extract_symbols_plain` on CUDA tensors is the unfused chain of
kernels the fused one replaced, which it equals bit for bit
(``tests/test_torch_cuda.py``): the reason K3's plane entry stays.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.device import kernel_route
from ..utils.trace import count
from . import _build
from .fetch_cuda import fetch_regions_plain

__all__ = ["extract_symbols", "extract_symbols_plain", "matched_filter", "matched_filter_plain"]


def matched_filter_plain(
    zr: torch.Tensor, zi: torch.Tensor, taps: torch.Tensor, sps: int,
    num_syms: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Vectorised counterpart of ``matched_filter_reference``: the windows
    as a strided view of the zero-extended regions, then one product and
    sum per output."""
    k = taps.shape[1]
    need = sps * (num_syms - 1) + k

    def one(z):
        if z.shape[1] < need:
            z = F.pad(z, (0, need - z.shape[1]))
        win = z.unfold(1, k, sps)[:, :num_syms]  # [D, S, K]
        return (win * taps[:, None, :]).sum(-1)

    return one(zr), one(zi)


def matched_filter(
    zr: torch.Tensor, zi: torch.Tensor, taps: torch.Tensor, sps: int,
    num_syms: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Filter+decimate: ``zr``/``zi`` float32 ``[D, R]``, ``taps`` float32
    ``[D, K]`` (time-reversed). Returns float32 ``[D, num_syms]`` planes."""
    route = kernel_route(zr, zi, taps)
    for name, t in (("zr", zr), ("zi", zi), ("taps", taps)):
        if t.dtype != torch.float32 or t.ndim != 2:
            raise ValueError(f"{name} must be a float32 matrix, got {t.dtype} {tuple(t.shape)}")
    d, r = zr.shape
    if zi.shape != zr.shape or taps.shape[0] != d:
        raise ValueError(f"shapes disagree: {tuple(zr.shape)}, {tuple(zi.shape)}, {tuple(taps.shape)}")
    if sps < 1 or num_syms < 1:
        raise ValueError(f"sps={sps} and num_syms={num_syms} must be positive")
    if route == "plain":
        return matched_filter_plain(zr, zi, taps, sps, num_syms)
    for t in (zr, zi, taps):
        if not t.is_contiguous():
            raise ValueError("matched_filter needs contiguous tensors")
    if d * -(-num_syms // 9) > 2**31 - 1:
        raise ValueError(f"D={d} x num_syms={num_syms} exceeds the kernel's grid")
    outr = zr.new_empty(d, num_syms)
    outi = zr.new_empty(d, num_syms)
    if d == 0:
        return outr, outi
    _build.launch(
        "matched", "pm_matched_filter", zr.device,
        zr.data_ptr(), zi.data_ptr(), taps.data_ptr(), outr.data_ptr(),
        outi.data_ptr(), r, taps.shape[1], int(sps), int(num_syms), d,
        _build.stream_of(zr),
    )
    return outr, outi


def extract_symbols_plain(
    x: torch.Tensor, row_len: int, n_base: torch.Tensor, chan: torch.Tensor | None,
    arm: torch.Tensor, arm_taps: torch.Tensor, freq: torch.Tensor, n0: torch.Tensor,
    amp_scale: torch.Tensor, sps: int, sym_offset: int, num_syms: int, chunk: int,
    *, fetch=fetch_regions_plain, filt=matched_filter_plain,
) -> torch.Tensor:
    """The extraction as separate passes, a chunk at a time: fetch each
    row's region (``fetch``, K2's plain version), derotate it by
    ``exp(-i freq (n - n0))``, filter it at the row's arm (``filt``, K3's
    plain version), scale; then the chunks joined and cut to
    ``num_syms``."""
    kk = arm_taps.shape[1]
    taps = arm_taps[arm].flip(1).contiguous()  # [D, K] time-reversed
    region_len = sps * (chunk - 1) + kk
    j = torch.arange(region_len, device=x.device)
    out = []
    for c in range(-(-num_syms // chunk)):
        start = n_base + sps * (sym_offset + c * chunk) - (kk - 1)
        start = torch.clamp(start, 0, row_len - region_len)
        fetch_start = start if chan is None else start + chan * row_len
        rr, ri = fetch(x, fetch_start, region_len)
        ph = -freq[:, None] * (start[:, None] + j - n0[:, None]).to(torch.float32)
        cph, sph = torch.cos(ph), torch.sin(ph)
        dr = rr * cph - ri * sph
        di = rr * sph + ri * cph
        outr, outi = filt(dr, di, taps, sps, chunk)
        out.append(torch.complex(outr, outi) * amp_scale[:, None])
    return torch.cat(out, dim=1)[:, :num_syms].contiguous()


def extract_symbols(
    x: torch.Tensor, row_len: int, n_base: torch.Tensor, chan: torch.Tensor | None,
    arm: torch.Tensor, arm_taps: torch.Tensor, freq: torch.Tensor, n0: torch.Tensor,
    amp_scale: torch.Tensor, sps: int, sym_offset: int, num_syms: int, chunk: int,
) -> torch.Tensor:
    """``num_syms`` matched-filtered symbols from symbol ``sym_offset`` of
    each row, complex64 ``[D, num_syms]``. ``x``: the contiguous complex64
    bank flattened, ``row_len`` samples a channel (one capture: ``chan``
    None and ``row_len`` its length); ``n_base`` (int64 ``[D]``): each
    row's symbol 0, channel-local; ``chan``: int64 ``[D]`` channels;
    ``arm`` (int64 ``[D]``) picks each row's taps from ``arm_taps``
    (float32 ``[arms, K]``, not reversed); ``freq`` (float32 rad/sample)
    and ``n0`` (int64) set the derotation ``exp(-i freq (n - n0))``;
    ``amp_scale`` (float32) scales each row. Chunk ``c`` of ``chunk``
    symbols reads its region at ``clamp(n_base + sps (sym_offset + c
    chunk) - (K - 1), 0, row_len - R)``, ``R = sps (chunk - 1) + K``."""
    vecs = (n_base, arm, freq, n0, amp_scale) + (() if chan is None else (chan,))
    route = kernel_route(x, arm_taps, *vecs)
    d = n_base.shape[0]
    if x.dtype != torch.complex64 or x.ndim != 1 or x.shape[0] % row_len:
        raise ValueError(f"bank must be complex64 [C * {row_len}], got {x.dtype} {tuple(x.shape)}")
    if arm_taps.dtype != torch.float32 or arm_taps.ndim != 2:
        raise ValueError(f"arm taps must be a float32 matrix, got {arm_taps.dtype} {tuple(arm_taps.shape)}")
    for name, t, dt in (("n_base", n_base, torch.int64), ("chan", chan, torch.int64),
                        ("arm", arm, torch.int64), ("freq", freq, torch.float32),
                        ("n0", n0, torch.int64), ("amp_scale", amp_scale, torch.float32)):
        if t is not None and (t.dtype != dt or tuple(t.shape) != (d,)):
            raise ValueError(f"{name} must be {dt} [{d}], got {t.dtype} {tuple(t.shape)}")
    kk = arm_taps.shape[1]
    if not (sps >= 1 and num_syms >= 1 and chunk >= 1 and sps * (chunk - 1) + kk <= row_len):
        raise ValueError(f"sps {sps}, num_syms {num_syms}, chunk {chunk}: a region past the row of {row_len}")
    args = (x, row_len, n_base, chan, arm, arm_taps, freq, n0, amp_scale, sps, sym_offset, num_syms, chunk)
    if route == "plain":
        return extract_symbols_plain(*args)
    if not (x.is_contiguous() and arm_taps.is_contiguous()):
        raise ValueError("extract_symbols needs a contiguous bank and taps")
    out = x.new_empty(d, num_syms)
    if d == 0:
        return out
    n_base, arm, freq, n0, amp_scale = (t.contiguous() for t in (n_base, arm, freq, n0, amp_scale))
    chan = None if chan is None else chan.contiguous()
    _build.launch(
        "matched", "pm_extract_symbols", x.device,
        x.data_ptr(), n_base.data_ptr(), None if chan is None else chan.data_ptr(), n0.data_ptr(),
        arm.data_ptr(), arm_taps.data_ptr(), freq.data_ptr(), amp_scale.data_ptr(), out.data_ptr(),
        row_len, kk, int(sps), int(sym_offset), int(num_syms), int(chunk), d, _build.stream_of(x),
    )
    count("rx.extract.fused_rows", d)
    return out
