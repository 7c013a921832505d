#!/usr/bin/env python3
"""K4 (Costas) and K5 (LDPC) of two versions, in turns on one GPU.

The old versions are another commit's ``costas.cu`` and ``ldpc.cu`` in the
directory given with ``--old`` (unpacked from git beforehand, e.g.
``git show <commit>:gr4_packet_modem_tpu_torch/csrc/costas.cu``). Each is
compiled on its own with the port's flags (``ops/_build.py::build_single``)
and called as its own wrapper called it: the old K4 took its symbols as
``[S, B]``, so its call is the transpose in and the kernel; the old kernel
alone, on symbols transposed beforehand, is timed beside it. The new
versions are the port's wrappers. The inputs are chip_smoke.py's: the
locked loop at the header and payload shapes and noisy codewords from -6
to +4 dB, B=1536; and for K4 also the payload symbols and loop state that
the Costas carrier's bank step gives it at the bench geometry, once with
all rows (its invalid and suppressed detection slots included) and once
with the rows that cannot be accepted zeroed. Each old output is held
equal to the new one first.

Device time as ``chip_smoke.py::timed`` measures it, in the order old,
new, new, old (for K4: old call, old kernel, new, new, old kernel, old
call). Run: ``python3 scripts/kernel_turns_torch.py --old DIR``; writes
``chiprun_out/kernel_turns.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def step_payload(torch, cs, dev):
    """K4's payload-pass input in the Costas carrier's bank step at the
    bench geometry: ``(symbols [D, 6160], phase0, freq0, acceptable)``,
    ``acceptable`` the rows with ``header_ok & keep``."""
    import dataclasses

    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver

    rx = Receiver(dataclasses.replace(BENCH_CONFIG, payload_carrier="costas"), dev)
    samples, _, _ = cs.bench_signal(BENCH_BLOCK, BENCH_CHANNELS)
    x = torch.zeros(BENCH_CHANNELS, rx.front_pad + BENCH_BLOCK + rx.pad_tail(),
                    dtype=torch.complex64, device=dev)
    x[:, rx.front_pad : rx.front_pad + BENCH_BLOCK] = torch.from_numpy(samples).to(dev)
    det = rx.acquirer.acquire(x)
    d = rx.decode(x, det)
    chan = rx.channel_ids(*det.index.shape, det.index.device)  # the tensor decode flattened with
    hdr = d.hdr
    syms = rx._extract_symbols(x, hdr.n_base, hdr.arm, d.det.freq, d.det.index, hdr.amp_scale,
                               192, rx.config.max_payload_syms, chan)
    return syms, hdr.phase, hdr.freq, hdr.header_ok & d.keep


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, required=True, help="directory with the old costas.cu and ldpc.cu")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from gr4_packet_modem_tpu_torch.ops import _build, ldpc
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track
    from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols, ldpc_encode_bytes

    if not torch.cuda.is_available():
        raise SystemExit("kernel_turns_torch: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    old4 = _build.build_single(args.old / "costas.cu").pm_costas_track
    old4.argtypes = [P, P, P, P, P, P, I, I, I, P]
    old5 = _build.build_single(args.old / "ldpc.cu").pm_ldpc_totals
    old5.argtypes = [P, P, P, P, I, I, I, I, I, I, F, P]
    _build.library()
    dev = torch.device("cuda")
    d = 1536

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def old_kernel(sym_t, out_t, ph0, fr0, ph_end, fr_end, offset):
        s, b = sym_t.shape
        status = old4(sym_t.data_ptr(), out_t.data_ptr(), ph0.data_ptr(), fr0.data_ptr(),
                      ph_end.data_ptr(), fr_end.data_ptr(), b, s, offset, stream())
        cs.check(status == 0, f"old pm_costas_track: CUDA error {status}")

    def old_costas(sym, ph0, fr0, offset):
        sym_t = sym.transpose(0, 1).contiguous()
        out_t = torch.empty_like(sym_t)
        ph_end, fr_end = torch.empty_like(ph0), torch.empty_like(fr0)
        old_kernel(sym_t, out_t, ph0, fr0, ph_end, fr_end, offset)
        return out_t.transpose(0, 1), ph_end, fr_end

    def stimulus(s, offset):
        return [torch.from_numpy(a).to(dev) for a in costas_symbols(d, s, offset, seed=7 + s)]

    def acceptable_only(sym, ph0, fr0, ok):
        return (torch.where(ok[:, None], sym, torch.zeros_like(sym)),
                torch.where(ok, ph0, torch.zeros_like(ph0)), torch.where(ok, fr0, torch.zeros_like(fr0)))

    step = step_payload(torch, cs, dev)
    print(f"bank step payload: {int(step[3].sum())} of {step[3].numel()} rows can be accepted", flush=True)
    out = {"card": card}
    cases = [
        ("S=192", 192, 0, lambda: stimulus(192, 0)),
        ("S=6160", 6160, 192, lambda: stimulus(6160, 192)),
        ("bank step payload", 6160, 192, lambda: step[:3]),
        ("bank step payload, acceptable rows", 6160, 192, lambda: acceptable_only(*step)),
    ]
    for label, s, offset, make in cases:
        sym, ph0, fr0 = make()
        new, old = costas_track(sym, ph0, fr0, offset=offset), old_costas(sym, ph0, fr0, offset)
        for a, b in zip(new, old):  # the step's invalid slots may hold NaN
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        sym_t = sym.transpose(0, 1).contiguous()
        out_t, ph_end, fr_end = torch.empty_like(sym_t), torch.empty_like(ph0), torch.empty_like(fr0)
        calls = {
            "old": lambda: old_costas(sym, ph0, fr0, offset),
            "old kernel": lambda: old_kernel(sym_t, out_t, ph0, fr0, ph_end, fr_end, offset),
            "new": lambda: costas_track(sym, ph0, fr0, offset=offset),
        }
        order = ["old", "old kernel", "new", "new", "old kernel", "old"]
        turns = [(name, cs.timed(torch, calls[name])["ms"]) for name in order]
        print(f"costas {label} B={sym.shape[0]} S={s} offset={offset}: outputs equal; in turns "
              + ", ".join(f"{n} {t:.4f}" for n, t in turns) + f" ms  [{card}]", flush=True)
        out[f"costas {label}"] = turns
        del sym, sym_t, out_t, new, old
    del step

    rng = np.random.default_rng(7)
    headers = rng.integers(0, 256, (d, 4), dtype=np.uint8)
    cw = np.unpackbits(np.stack([ldpc_encode_bytes(h)[:16] for h in headers]), axis=1)
    snr_db = np.repeat(np.arange(-6.0, 6.0, 2.0), d // 6)[:, None]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    llr = (2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))
    llr = torch.from_numpy(llr.astype(np.float32)).to(dev)
    t = ldpc.decoder_tables()
    cv, ve = (torch.from_numpy(a).to(dev) for a in ldpc.edge_tables(t["vidx"], t["vmask"], 128))
    (m, dmax), (n, vdeg) = cv.shape, ve.shape
    alpha = float(np.float32(0.75))

    def old_ldpc():
        totals = torch.empty_like(llr)
        status = old5(llr.data_ptr(), totals.data_ptr(), cv.data_ptr(), ve.data_ptr(),
                      d, m, dmax, n, vdeg, 25, alpha, stream())
        cs.check(status == 0, f"old pm_ldpc_totals: CUDA error {status}")
        return totals

    cs.check(torch.equal(old_ldpc(), ldpc_totals(llr, cv, ve)), "ldpc: old and new differ")
    calls = {"old": old_ldpc, "new": lambda: ldpc_totals(llr, cv, ve)}
    turns = [(name, cs.timed(torch, calls[name])["ms"]) for name in ("old", "new", "new", "old")]
    print(f"ldpc B={d} iters=25: totals equal; in turns "
          + ", ".join(f"{n} {t:.4f}" for n, t in turns) + f" ms  [{card}]", flush=True)
    out["ldpc"] = turns
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "kernel_turns.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
