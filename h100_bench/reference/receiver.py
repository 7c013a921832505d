"""The plain reference receiver that decides a run's ``correct``.

Plain PyTorch in float32, written out stage by stage from the modem's
published description and the frozen constants beside it; it imports
nothing of the program, takes none of its tables and runs no hand-written
kernel. Its tables (RRC and polyphase taps, the syncword replicas and
their spectra, the noise filter, the LDPC parity checks, the scrambler
keystream) are derived here from ``constants.py``, ``firdes.py``,
``lfsr.py`` and ``data/``.

The chain, for a bank ``[C, T]`` of padded captures:

1. acquisition: overlap-save FFT correlation against the ``2 * freq_bins
   + 1`` frequency-shifted syncword replicas, best bin per sample, the
   windowed peak detector with its CFAR test, and the closed-form
   estimates (syncword_detection.hpp:56-115);
2. header pass: the region of each detection derotated and filtered by
   its polyphase arm, the syncword wiped off, the Costas loop as a Python
   loop over symbols, LLRs, descrambling, normalised min-sum over the
   (128, 32) code's parity checks, the header parsed;
3. suppression of detections inside an earlier packet;
4. payload pass: the same extraction from symbol 192, the V&V block
   estimator or the Costas loop, slicing, byte packing, and the CRC-32
   checked with ``zlib`` on the host.

Departures from the program, each of which leaves every number a correct
program computes equal up to float32 rounding: the correlation runs as
whole FFTs (the program's K1 keeps only the best bin's power, and its
phase and neighbour powers come from direct dots); the symbol extraction
takes each region in one piece (the program cuts extractions longer than
8,192 symbols into chunks, which the configurations here never reach);
the CRC is zlib's.
"""

from __future__ import annotations

import zlib
from functools import lru_cache
from importlib import resources

import numpy as np
import torch

from . import constants as C
from .firdes import rx_pfb_taps, rx_rrc_taps
from .lfsr import additive_scrambler_keystream

__all__ = ["ReferenceReceiver"]

PI = float(np.float32(np.pi))
TWO_PI = float(2 * np.float32(np.pi))
HDR_SYMS = C.SYNCWORD_LEN + C.HEADER_SYMBOLS  # 192


def modulated_syncword(sps: int) -> tuple[np.ndarray, float]:
    """The RRC-shaped BPSK syncword and its energy
    (syncword_detection.hpp:154-164)."""
    taps, _ = rx_rrc_taps(sps)
    const = np.asarray(C.BPSK_CONSTELLATION)
    out = np.zeros((C.SYNCWORD_LEN - 1) * sps + taps.size, np.complex64)
    for j, b in enumerate(np.asarray(C.SYNCWORD)):
        out[j * sps : j * sps + taps.size] += const[b] * taps
    return out, float(np.sum(np.abs(out) ** 2))


def costas_gains(bw: float, qpsk: bool) -> tuple[float, float]:
    """Loop gains from the bandwidth B_L*T (costas_loop.hpp:67-87)."""
    bw2, bw3, bw4 = bw * bw, bw**3, bw**4
    s = np.cbrt(36.0 * bw2 + np.sqrt(3.0) * np.sqrt(432.0 * bw4 + 848.0 * bw3 + 624.0 * bw2
                                                    + 204.0 * bw + 25.0) + 36.0 * bw + 9.0)
    z = (-(-12.0 * bw - 6.0) / (3.0 * np.cbrt(6.0) * (2.0 * bw + 1.0) * s)
         + (np.cbrt(2.0) * s) / (np.cbrt(9.0) * (2.0 * bw + 1.0)) - 1.0)
    g = np.sqrt(2.0) if qpsk else 1.0
    return float(np.float32((1.0 - z * z) / g)), float(np.float32((1.0 - z) ** 2 / g))


@lru_cache(maxsize=1)
def parity_checks() -> np.ndarray:
    """H ``[96, 128]`` of the header code, from the alist file."""
    text = resources.files("h100_bench.reference").joinpath("data").joinpath(
        "header_ldpc.alist").read_text()
    lines = [ln for ln in text.split("\n") if ln.strip()]
    n, m = map(int, lines[0].split())
    h = np.zeros((m, n), np.uint8)
    for v in range(n):
        for c in map(int, lines[4 + v].split()):
            h[c - 1, v] = 1
    return h


class ReferenceReceiver:
    """``decode(x)`` of a bank of padded captures ``[C, T]`` complex64 on
    ``device``; ``cfg`` holds the configuration file's ``rx`` fields."""

    def __init__(self, cfg: dict, device: torch.device):
        self.dev = device
        self.sps = sps = int(cfg.get("samples_per_symbol", 4))
        self.n_fft = int(cfg["acquisition_fft_size"])
        self.freq_bins = int(cfg["freq_bins"])
        self.max_det = int(cfg["max_detections"])
        self.max_len = int(cfg["max_payload_len"])
        self.carrier = cfg["payload_carrier"]
        self.vv_block = int(cfg.get("vv_block", 64))
        self.ldpc_iters = int(cfg.get("ldpc_iterations", 25))
        self.arms = int(cfg.get("num_pfb_arms", 32))
        self.w = C.SYNC_TIME_THRESHOLD
        self.power_threshold = float(cfg.get("power_threshold", C.SYNC_POWER_THRESHOLD))
        rep, self.self_corr = modulated_syncword(sps)
        self.sync_len = rep.size
        bins = np.arange(-self.freq_bins, self.freq_bins + 1)
        k = np.arange(self.sync_len)
        reps = (rep[None] * np.exp(1j * (bins[:, None] * np.pi / self.sync_len) * k[None])).astype(np.complex64)
        self.replicas = torch.from_numpy(reps).to(device)
        padded = torch.zeros(len(bins), self.n_fft, dtype=torch.complex64, device=device)
        padded[:, : self.sync_len] = self.replicas
        self.replica_fft_conj = torch.fft.fft(padded).conj()
        from scipy import signal

        hp = signal.remez(33, [0.0, 0.22, 0.3, 0.5], [0.0, 1.0], fs=1.0).astype(np.float32)
        self.noise_taps = hp[::-1].tolist()
        self.noise_gain = float(np.float32(np.sum(hp.astype(np.float64) ** 2)))
        self.filter_delay = rx_rrc_taps(sps)[0].size - 1
        pfb = rx_pfb_taps(sps, self.arms)
        self.arm_len = pfb.size // self.arms
        self.arm_taps = torch.from_numpy(pfb.reshape(self.arm_len, self.arms).T.copy()).to(device)
        self.sync_bipolar = torch.from_numpy(
            np.where(np.asarray(C.SYNCWORD) != 0, -1.0, 1.0).astype(np.float32)).to(device)
        self.llr_scale = float(np.float32(2.0 / C.LLR_NOISE_SIGMA**2))
        self.s_pay = 4 * (self.max_len + C.CRC_NUM_BYTES)
        ks = additive_scrambler_keystream(C.HEADER_LLRS + 2 * self.s_pay).astype(bool)
        self.ks = torch.from_numpy(ks).to(device)
        h = parity_checks()
        self.h = torch.from_numpy(h.astype(np.float32)).to(device)
        self.checks = [np.nonzero(row)[0] for row in h]

    # ------------------------------------------------------------ geometry

    @property
    def front_pad(self) -> int:
        return C.SYNC_TIME_THRESHOLD + self.filter_delay + 20

    def pad_tail(self) -> int:
        extraction = self.sps * (HDR_SYMS + self.s_pay) + self.arm_len + 8
        return extraction + C.SYNC_TIME_THRESHOLD + self.n_fft

    # ---------------------------------------------------------- acquisition

    def _best_bin_power(self, x: torch.Tensor):
        """Best-bin power and bin ``[C, F*S]``, and the full per-bin
        correlations ``[C, nb, F*S]``, by overlap-save FFTs."""
        n = self.n_fft
        s = n - self.sync_len + 1
        c, t = x.shape
        nf = (t - n) // s + 1
        frames = x.unfold(1, n, s)[:, :nf]  # [C, F, N]
        spec = torch.fft.fft(frames, dim=-1)
        corr = torch.fft.ifft(spec[:, :, None, :] * self.replica_fft_conj[None, None], dim=-1)[..., :s]
        corr = corr.permute(0, 2, 1, 3).reshape(c, -1, nf * s)
        power = corr.real**2 + corr.imag**2
        return power.amax(dim=1), power.argmax(dim=1), corr, power

    def _peaks(self, best_pow: torch.Tensor):
        """Windowed peak detection and CFAR over ``best_pow`` ``[C, T']``: a
        sample is an event where it is the first maximum of its centred
        window ``[t-w, t+w]`` (greater than every sample before it, not less
        than any after it), both halves exist, and at least half the window
        lies below ``power / power_threshold``; the slots go to the
        strongest events."""
        w, d = self.w, self.max_det
        c, tlen = best_pow.shape
        padded = torch.nn.functional.pad(best_pow, (w, w), value=-torch.inf)
        run_max = torch.nn.functional.max_pool1d(padded[:, None], w, stride=1)[:, 0]
        left_max = run_max[:, :tlen]  # max of [t-w, t-1]
        right_max = run_max[:, w + 1 : w + 1 + tlen]  # max of [t+1, t+w]
        t = torch.arange(tlen, device=best_pow.device)
        peak = ((best_pow > left_max) & (best_pow >= right_max) & (t >= w) & (t < tlen - w)
                & (best_pow > 0))
        ci, ti = peak.nonzero(as_tuple=True)
        below = torch.zeros(ci.numel(), dtype=torch.long, device=best_pow.device)
        for r in range(0, ci.numel(), 4096):  # the CFAR window of each peak
            sl = slice(r, r + 4096)
            win = padded.unfold(1, 2 * w + 1, 1)[ci[sl], ti[sl]]
            below[sl] = (win < (best_pow[ci[sl], ti[sl]] / self.power_threshold)[:, None]).sum(-1)
        passing = torch.zeros_like(peak)
        passing[ci, ti] = 2 * below >= 2 * w + 1
        overflow = passing.sum(-1) > d
        score = torch.where(passing, best_pow, torch.full_like(best_pow, -1.0))
        top_pow, top_idx = torch.topk(score, d, dim=-1)
        return top_pow, top_idx, overflow

    def acquire(self, x: torch.Tensor) -> dict:
        """Detections ``[C, D]`` sorted by index, invalid last, eight
        channels at a time (the full correlations take 20 bytes a sample
        and bin)."""
        parts = [self._acquire(g) for g in x.split(8)]
        return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    def _acquire(self, x: torch.Tensor) -> dict:
        c, t = x.shape
        w, nb = self.w, 2 * self.freq_bins + 1
        best_pow, best_bin, corr, power = self._best_bin_power(x)
        tlen = best_pow.shape[1]
        top_pow, ti, overflow = self._peaks(best_pow)
        valid = top_pow > 0
        b = top_pow
        bi = best_bin.gather(1, ti)
        flat = power.reshape(c, -1)
        p_left = flat.gather(1, (bi - 1).clamp(min=0) * tlen + ti)
        p_right = flat.gather(1, (bi + 1).clamp(max=nb - 1) * tlen + ti)
        peak = corr.reshape(c, -1).gather(1, bi * tlen + ti)
        phase_raw = torch.atan2(peak.imag, peak.real)
        del corr, power, flat
        spacing = float(np.float32(np.pi / self.sync_len))
        interior = (bi > 0) & (bi < nb - 1)
        denom_f = 2.0 * (2.0 * b - (p_left + p_right))
        safe_f = torch.where(denom_f == 0, 1.0, denom_f)
        quad = torch.clamp((p_right - p_left) / safe_f, -0.5, 0.5)
        dfreq = torch.where(interior, quad * spacing, 0.0)
        freq = (bi - self.freq_bins).float() * spacing + dfreq
        phase = phase_raw - dfreq * 0.5 * float(self.sync_len)
        phase = torch.where(phase >= PI, phase - TWO_PI, phase)
        phase = torch.where(phase < -PI, phase + TWO_PI, phase)
        p_interp = torch.where(
            interior, b + (p_right - p_left) ** 2 / torch.where(denom_f == 0, 1.0, 4.0 * denom_f), b)
        amplitude = torch.sqrt(torch.clamp(p_interp, min=0.0)) / float(np.float32(self.self_corr))
        pa = best_pow.gather(1, (ti - 1).clamp(0, tlen - 1))
        pc = best_pow.gather(1, (ti + 1).clamp(0, tlen - 1))
        denom_t = 2.0 * (2.0 * b - (pa + pc))
        time_est = torch.clamp((pc - pa) / torch.where(denom_t == 0, 1.0, denom_t), -0.5, 0.5)
        # noise: the out-of-band power in the CFAR window around each
        # candidate, scaled to full band
        k = len(self.noise_taps)
        region = 2 * w + k
        start = torch.clamp(ti - w - (k - 1) // 2, 0, t - region)
        win = x.unfold(1, region, 1)[torch.arange(c, device=x.device)[:, None], start]
        hp = sum(tap * win[..., j : j + 2 * w + 1] for j, tap in enumerate(self.noise_taps))
        noise = torch.clamp((hp.real**2 + hp.imag**2).mean(-1) / self.noise_gain, min=1e-12)
        sc = float(np.float32(self.self_corr))
        sync_power = amplitude**2 * sc
        esn0 = 10.0 * torch.log10(torch.clamp(
            sync_power * float(self.sps) / (noise * float(self.sync_len)), min=1e-12))
        order = torch.argsort(torch.where(valid, ti, torch.iinfo(torch.int32).max), dim=1, stable=True)
        det = dict(index=ti, valid=valid, amplitude=amplitude, phase=phase, freq=freq,
                   time_est=time_est, esn0_db=esn0)
        det = {name: v.gather(1, order) for name, v in det.items()}
        det["overflow"] = overflow
        return det

    # --------------------------------------------------- symbol extraction

    def _extract(self, x, chan, n_base, arm, freq, n0, amp_scale, sym_offset, num_syms):
        """``num_syms`` matched-filtered symbols from symbol ``sym_offset``
        of each row: the region derotated by ``exp(-i freq (n - n0))``,
        filtered by the row's arm (time-reversed taps), decimated by sps,
        scaled by ``amp_scale``."""
        sps, kk = self.sps, self.arm_len
        t = x.shape[1]
        region = sps * (num_syms - 1) + kk
        start = torch.clamp(n_base + sps * sym_offset - (kk - 1), 0, t - region)
        taps = self.arm_taps[arm].flip(1)
        j = torch.arange(region, device=x.device)
        out = []
        for r in range(0, chan.numel(), 256):
            sl = slice(r, r + 256)
            seg = x.unfold(1, region, 1)[chan[sl], start[sl]]  # [R, region]
            ph = -freq[sl, None] * (start[sl, None] + j - n0[sl, None]).float()
            seg = seg * torch.complex(torch.cos(ph), torch.sin(ph))
            win = seg.unfold(1, kk, sps)[:, :num_syms]  # [R, S, K]
            y = (win.real * taps[sl, None]).sum(-1) + 1j * (win.imag * taps[sl, None]).sum(-1)
            out.append(y.to(torch.complex64) * amp_scale[sl, None])
        return torch.cat(out)

    def _costas(self, syms, phase, freq, offset):
        """The decision-directed Costas loop, one symbol at a time: PILOT
        below symbol 64, QPSK after, at bandwidth 0.02 / 0.01 / 0.005 for
        the syncword, header and payload (payload_metadata_insert.hpp:
        63-65)."""
        g_sync = costas_gains(C.SYNCWORD_COSTAS_BW, False)
        g_hdr = costas_gains(C.HEADER_COSTAS_BW, True)
        g_pay = costas_gains(C.PAYLOAD_COSTAS_BW, True)
        out_r = torch.empty(syms.shape, dtype=torch.float32, device=syms.device)
        out_i = torch.empty_like(out_r)
        xr_all, xi_all = syms.real, syms.imag
        for s in range(syms.shape[1]):
            pos = s + offset
            g1, g2 = g_sync if pos < C.SYNCWORD_LEN else g_hdr if pos < HDR_SYMS else g_pay
            xr, xi = xr_all[:, s], xi_all[:, s]
            cs, sn = torch.cos(phase), torch.sin(phase)
            zr = xr * cs + xi * sn
            zi = xi * cs - xr * sn
            if pos < C.SYNCWORD_LEN:
                e = zi
            else:
                e = torch.where(zr > 0, zi, -zi) + torch.where(zi > 0, -zr, zr)
            freq = freq + g2 * e
            phase = phase + g1 * e + freq
            phase = torch.where(phase >= PI, phase - TWO_PI, phase)
            phase = torch.where(phase < -PI, phase + TWO_PI, phase)
            out_r[:, s] = zr
            out_i[:, s] = zi
        return torch.complex(out_r, out_i), phase, freq

    def _vv(self, syms, phase0, freq0):
        """Viterbi & Viterbi: the header-end loop state carried linearly, then
        a 4th-power phase per block of ``vv_block`` symbols, unwrapped block
        to block and interpolated between block centres."""
        blk = self.vv_block
        d, s = syms.shape
        nb = s // blk
        idx = torch.arange(s, device=syms.device, dtype=torch.float32)
        base = phase0[:, None] + freq0[:, None] * idx[None]
        z = syms * torch.complex(torch.cos(base), -torch.sin(base))
        zb = z[:, : nb * blk].reshape(d, nb, blk)
        z2 = zb * zb
        ph4 = torch.angle((z2 * z2).mean(-1))
        d4 = torch.diff(ph4, dim=-1)
        d4 = torch.where(d4 > PI, d4 - TWO_PI, d4)
        d4 = torch.where(d4 < -PI, d4 + TWO_PI, d4)
        quarter = float(np.float32(np.pi / 4))
        r0 = torch.remainder((ph4[:, :1] - PI) / 4.0 + quarter, float(np.float32(np.pi / 2))) - quarter
        resid = torch.cat([r0, r0 + torch.cumsum(d4 / 4.0, dim=-1)], dim=-1)
        pos = (np.arange(s) - (blk - 1) / 2.0) / blk
        b0 = np.clip(np.floor(pos).astype(np.int64), 0, nb - 1)
        b1 = np.clip(b0 + 1, 0, nb - 1)
        frac = torch.from_numpy(np.clip(pos - b0, 0.0, 1.0).astype(np.float32)).to(syms.device)
        b0, b1 = torch.from_numpy(b0).to(syms.device), torch.from_numpy(b1).to(syms.device)
        per_sym = resid[:, b0] * (1.0 - frac) + resid[:, b1] * frac
        return z * torch.complex(torch.cos(per_sym), -torch.sin(per_sym))

    def _ldpc(self, llrs: torch.Tensor):
        """Flooding normalised min-sum (factor 0.75) over H, then the hard
        decision and the syndrome. Returns (info bits [B, 32], ok [B])."""
        b, n = llrs.shape
        msgs = [torch.zeros(b, len(vs), device=llrs.device) for vs in self.checks]
        alpha = float(np.float32(0.75))

        def totals():
            tot = llrs.clone()
            for vs, m in zip(self.checks, msgs):
                tot[:, vs] += m
            return tot

        for _ in range(self.ldpc_iters):
            tot = totals()
            for i, vs in enumerate(self.checks):
                v2c = tot[:, vs] - msgs[i]
                sgn = torch.where(v2c >= 0, 1.0, -1.0)
                mag = v2c.abs()
                m1, a1 = mag.min(-1, keepdim=True)
                m2 = mag.scatter(-1, a1, torch.inf).min(-1, keepdim=True).values
                out = torch.where(torch.arange(len(vs), device=llrs.device) == a1, m2, m1)
                msgs[i] = alpha * sgn.prod(-1, keepdim=True) * sgn * torch.clamp(out, max=1e30)
        hard = (totals() < 0).float()
        ok = ((hard @ self.h.T).round().long() & 1).eq(0).all(-1)
        return hard[:, : C.HEADER_LDPC_K].to(torch.uint8), ok

    @staticmethod
    def _pack(bits: torch.Tensor) -> torch.Tensor:
        w = 1 << torch.arange(7, -1, -1, device=bits.device)
        return (bits.long().reshape(bits.shape[0], -1, 8) * w).sum(-1)

    # --------------------------------------------------------------- decode

    @torch.no_grad()
    def decode(self, x: torch.Tensor) -> dict:
        """Every stage's result for the bank ``x`` ``[C, T]``, as numpy
        arrays ``[C, D]`` (``data`` ``[C, D, max_payload_len]``)."""
        c = x.shape[0]
        d = self.max_det
        det = self.acquire(x)
        flat = {k: v.reshape(-1) for k, v in det.items() if k != "overflow"}
        chan = torch.arange(c, device=x.device).repeat_interleave(d)
        neg = flat["time_est"] < 0
        te = torch.where(neg, flat["time_est"] + 1.0, flat["time_est"])
        arm = torch.clamp(torch.round(self.arms * te).long(), 0, self.arms - 1)
        n_base = flat["index"] + self.filter_delay - neg.long()
        phase0 = torch.where(neg, flat["phase"] - flat["freq"], flat["phase"])
        amp_scale = 1.0 / torch.clamp(flat["amplitude"], min=1e-9)
        # header pass
        syms = self._extract(x, chan, n_base, arm, flat["freq"], flat["index"], amp_scale, 0, HDR_SYMS)
        syms[:, : C.SYNCWORD_LEN] *= self.sync_bipolar
        corrected, ph_end, fr_end = self._costas(syms, phase0, torch.zeros_like(phase0), 0)
        hdr = corrected[:, C.SYNCWORD_LEN :]
        llrs = torch.view_as_real(hdr).reshape(hdr.shape[0], -1) * self.llr_scale
        llrs = torch.where(self.ks[: C.HEADER_LLRS], -llrs, llrs)
        bits, ldpc_ok = self._ldpc(llrs[:, : C.HEADER_LDPC_N] + llrs[:, C.HEADER_LDPC_N :])
        hb = self._pack(bits)
        length = hb[:, 0] << 8 | hb[:, 1]
        ptype = hb[:, 2]
        header_ok = ldpc_ok & flat["valid"] & (length > 0) & (ptype <= 1) & (length <= self.max_len)
        # suppression, per channel in index order
        extent = torch.where(header_ok, self.sps * (HDR_SYMS + 4 * (length + C.CRC_NUM_BYTES)),
                             self.sps * HDR_SYMS).view(c, d)
        idx2, val2 = det["index"], det["valid"]
        busy = torch.full((c,), -1, device=x.device, dtype=torch.long)
        keep = []
        for i in range(d):
            k = val2[:, i] & (idx2[:, i] >= busy)
            busy = torch.where(k, idx2[:, i] + extent[:, i], busy)
            keep.append(k)
        keep = torch.stack(keep, 1).reshape(-1)
        # payload pass
        syms = self._extract(x, chan, n_base, arm, flat["freq"], flat["index"], amp_scale,
                             HDR_SYMS, self.s_pay)
        if self.carrier == "vv":
            corrected = self._vv(syms, ph_end, fr_end)
        else:
            corrected, _, _ = self._costas(syms, ph_end, fr_end, HDR_SYMS)
        llrs = torch.view_as_real(corrected).reshape(corrected.shape[0], -1) * self.llr_scale
        llrs = torch.where(self.ks[C.HEADER_LLRS :], -llrs, llrs)
        all_bytes = self._pack((llrs < 0).to(torch.uint8)).to(torch.uint8).cpu().numpy()
        length_np = length.cpu().numpy()
        keep_np = keep.cpu().numpy()
        data = np.zeros((c * d, self.max_len), np.uint8)
        crc_ok = np.zeros(c * d, bool)
        for r in range(c * d):
            n = int(min(max(length_np[r], 0), self.max_len))
            data[r, :n] = all_bytes[r, :n]
            at = int(min(max(length_np[r], 0), all_bytes.shape[1] - C.CRC_NUM_BYTES))
            rx_crc = int.from_bytes(all_bytes[r, at : at + 4].tobytes(), "big")
            crc_ok[r] = keep_np[r] and zlib.crc32(data[r, :n].tobytes()) == rx_crc
        out = {k: v.cpu().numpy().reshape(c, d) for k, v in flat.items()}
        out.update(
            length=length_np.reshape(c, d), packet_type=ptype.cpu().numpy().reshape(c, d),
            header_ok=header_ok.cpu().numpy().reshape(c, d), keep=keep_np.reshape(c, d),
            crc_ok=crc_ok.reshape(c, d), data=data.reshape(c, d, self.max_len),
            overflow=det["overflow"].cpu().numpy(),
        )
        out["accepted"] = out["keep"] & out["header_ok"] & out["crc_ok"] & (out["packet_type"] == 0)
        return out
