"""The plain reference receiver of a sliding bank: ``ReferenceReceiver``
(``receiver.py``) with the stream step's fresh window and its carried
suppression state.

A stream's bank ``[C, front_pad + block + pad_tail]`` slides by ``block``
samples a step: its first ``front_pad`` samples are look-back, its last
``pad_tail`` the lookahead that finishes a packet. So that each syncword
is acquired in exactly one step,

- only a sample of the fresh window ``[front_pad, front_pad + block)`` may
  be a detection event, and the window applies before the slots go to the
  strongest events (the peak and CFAR tests still read the samples around
  it);
- the suppression scan starts from the state the last step handed on (a
  channel's busy-until in this bank's coordinates), and the state this
  step hands on is its busy-until moved back by ``block`` (never below
  ``IDLE_BUSY``, a channel with no packet in flight).

Plain PyTorch in float32, as ``receiver.py``; it imports nothing of the
program. The decode is ``ReferenceReceiver.decode``'s chain written out
again with the scan's seed (the base class starts every scan idle); its
stages are the base class's methods. Departures from upstream, each one
the program's too: the fresh window and the carried state are the
sliding bank's, where upstream's receiver runs sample by sample and needs
neither.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from . import constants as C
from .receiver import HDR_SYMS, ReferenceReceiver

__all__ = ["IDLE_BUSY", "ReferenceStreamReceiver"]

IDLE_BUSY = -(1 << 30)


class ReferenceStreamReceiver(ReferenceReceiver):
    """``decode(x, busy0)`` of a sliding bank ``[C, front_pad + block +
    pad_tail]`` on ``device``; ``cfg`` holds the configuration file's
    ``rx`` fields."""

    def __init__(self, cfg: dict, device: torch.device, block: int):
        super().__init__(cfg, device)
        self.block = int(block)

    def _peaks(self, best_pow: torch.Tensor):
        """``ReferenceReceiver._peaks`` with the events held to the fresh
        window before the slots are chosen."""
        w, d = self.w, self.max_det
        c, tlen = best_pow.shape
        padded = torch.nn.functional.pad(best_pow, (w, w), value=-torch.inf)
        run_max = torch.nn.functional.max_pool1d(padded[:, None], w, stride=1)[:, 0]
        left_max = run_max[:, :tlen]
        right_max = run_max[:, w + 1 : w + 1 + tlen]
        t = torch.arange(tlen, device=best_pow.device)
        fresh = (t >= self.front_pad) & (t < self.front_pad + self.block)
        peak = ((best_pow > left_max) & (best_pow >= right_max) & (t >= w) & (t < tlen - w)
                & (best_pow > 0) & fresh)
        ci, ti = peak.nonzero(as_tuple=True)
        below = torch.zeros(ci.numel(), dtype=torch.long, device=best_pow.device)
        for r in range(0, ci.numel(), 4096):
            sl = slice(r, r + 4096)
            win = padded.unfold(1, 2 * w + 1, 1)[ci[sl], ti[sl]]
            below[sl] = (win < (best_pow[ci[sl], ti[sl]] / self.power_threshold)[:, None]).sum(-1)
        passing = torch.zeros_like(peak)
        passing[ci, ti] = 2 * below >= 2 * w + 1
        overflow = passing.sum(-1) > d
        score = torch.where(passing, best_pow, torch.full_like(best_pow, -1.0))
        top_pow, top_idx = torch.topk(score, d, dim=-1)
        return top_pow, top_idx, overflow

    @torch.no_grad()
    def decode(self, x: torch.Tensor, busy0: np.ndarray) -> dict:
        """Every stage's result for the bank ``x`` ``[C, T]`` with the scan
        seeded by ``busy0`` ``[C]``, as ``ReferenceReceiver.decode``'s
        numpy arrays, and ``busy_next`` ``[C]``, the state handed on."""
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
        # suppression, per channel in index order, from the carried state
        extent = torch.where(header_ok, self.sps * (HDR_SYMS + 4 * (length + C.CRC_NUM_BYTES)),
                             self.sps * HDR_SYMS).view(c, d)
        idx2, val2 = det["index"], det["valid"]
        busy = torch.from_numpy(np.asarray(busy0, np.int64)).to(x.device)
        keep = []
        for i in range(d):
            k = val2[:, i] & (idx2[:, i] >= busy)
            busy = torch.where(k, idx2[:, i] + extent[:, i], busy)
            keep.append(k)
        keep = torch.stack(keep, 1).reshape(-1)
        busy_next = torch.clamp(busy - self.block, min=IDLE_BUSY).cpu().numpy()
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
            overflow=det["overflow"].cpu().numpy(), busy_next=busy_next,
        )
        out["accepted"] = out["keep"] & out["header_ok"] & out["crc_ok"] & (out["packet_type"] == 0)
        return out
