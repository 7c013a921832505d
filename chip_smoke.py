#!/usr/bin/env python3
"""Drive the PyTorch port's receive chain once on one NVIDIA GPU.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels (``gr4_packet_modem_tpu_torch/csrc``)
   with nvcc into ``build/kernels/``;
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the receive chain's shapes, and time both (CUDA events, median);
4. slice: ``Receiver.bank_step`` at the bench geometry (64 channels of
   2**19 samples of back-to-back 1500-byte bursts, 9 frequency bins,
   1536-byte max payload, 24 detection slots, V&V payload carrier, fft
   acquisition); every packet fully inside the block must decode
   byte-exact, and every kernel must have been launched by that run. Then
   the rate, the split by stage and the peak device memory, and one call
   of the single-channel ``entry()`` step.

The stimulus is made in numpy by ``tests/reference_impl.py`` (the
sequential transmitter the JAX transmitter is pinned to). The last line of
output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels as JSON. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

REPLACES = {
    "fetch": ("gr4_packet_modem_tpu_torch/csrc/fetch.cu",
              "gr4_packet_modem_tpu/ops/fetch_pallas.py:303"),
    "matched": ("gr4_packet_modem_tpu_torch/csrc/matched.cu",
                "gr4_packet_modem_tpu/ops/matched_pallas.py:133"),
    "costas": ("gr4_packet_modem_tpu_torch/csrc/costas.cu",
               "gr4_packet_modem_tpu/ops/costas_pallas.py:183"),
    "ldpc": ("gr4_packet_modem_tpu_torch/csrc/ldpc.cu",
             "gr4_packet_modem_tpu/ops/ldpc_pallas.py:139"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def time_ms(torch, fn, reps: int = 10) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events),
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


# ---------------------------------------------------------------- kernels


def kernel_checks(torch, card: str) -> dict:
    """Each kernel against its plain version at the chain's shapes."""
    from gr4_packet_modem_tpu_torch.ops import ldpc
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain
    from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_regions, fetch_regions_plain
    from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals
    from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter, matched_filter_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    d = 1536  # 64 channels x 24 detection slots
    res = {}

    def record(name, shape, err, ms, plain_ms, main):
        log(f"  {name:8s} {shape:34s} max_abs_err={err:.3e} kernel={ms:.4f} ms "
            f"plain={plain_ms:.4f} ms  [{card}]")
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r["ms"], r["plain_ms"] = ms, plain_ms

    # K2 region fetch: the flattened 64-channel bank plane, odd starts
    t = 64 * 553_396
    xr = torch.randn(t, generator=gen, device=dev)
    xi = torch.randn(t, generator=gen, device=dev)
    for r in (1569, 808, 24_680):
        starts = 2 * torch.randint(0, (t - r) // 2, (d,), generator=gen, device=dev) + 1
        starts[0], starts[1] = 1, t - r
        kr, ki = fetch_regions(xr, xi, starts, r)
        torch.cuda.synchronize()
        pr, pi = fetch_regions_plain(xr, xi, starts, r)
        check(torch.equal(kr, pr) and torch.equal(ki, pi), f"fetch R={r}: not bit-exact")
        ms = time_ms(torch, lambda: fetch_regions(xr, xi, starts, r))
        pms = time_ms(torch, lambda: fetch_regions_plain(xr, xi, starts, r))
        record("fetch", f"D={d} R={r}", 0.0, ms, pms, r == 24_680)
    del xr, xi

    # K3 matched filter: header (S=192) and payload (S=6160) passes
    k, sps = 44, 4
    taps = torch.randn(d, k, generator=gen, device=dev)
    for s in (192, 6160):
        r = sps * (s - 1) + k
        zr = torch.randn(d, r, generator=gen, device=dev)
        zi = torch.randn(d, r, generator=gen, device=dev)
        kr, ki = matched_filter(zr, zi, taps, sps, s)
        torch.cuda.synchronize()
        pr, pi = matched_filter_plain(zr, zi, taps, sps, s)
        for a, b in ((kr, pr), (ki, pi)):
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-4), f"matched S={s}: beyond rtol 1e-5 atol 1e-4")
        err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        ms = time_ms(torch, lambda: matched_filter(zr, zi, taps, sps, s))
        pms = time_ms(torch, lambda: matched_filter_plain(zr, zi, taps, sps, s))
        record("matched", f"D={d} S={s} R={r}", err, ms, pms, s == 6160)
        del zr, zi, pr, pi, kr, ki

    # K4 Costas loop: a locked loop on noisy QPSK with residual CFO (the
    # regime the receiver runs it in), header and payload geometries
    rng = np.random.default_rng(7)
    for s, offset in ((192, 0), (6160, 192)):
        bits = rng.integers(0, 4, (d, s))
        clean = np.exp(1j * (np.pi / 4 + bits * np.pi / 2))
        if offset == 0:
            clean[:, :64] = 1.0  # wiped-off syncword: pure pilot
        cfo = 2e-4 * rng.standard_normal((d, 1))
        sym = clean * np.exp(1j * (0.05 * rng.standard_normal((d, 1)) + cfo * np.arange(s)))
        sym = sym + 0.05 * (rng.standard_normal((d, s)) + 1j * rng.standard_normal((d, s)))
        sym = torch.from_numpy(sym.astype(np.complex64)).to(dev)
        ph0 = torch.from_numpy(rng.uniform(-0.1, 0.1, d).astype(np.float32)).to(dev)
        fr0 = torch.zeros(d, device=dev)
        ko, kph, kfr = costas_track(sym, ph0, fr0, offset=offset)
        torch.cuda.synchronize()
        po, pph, pfr = costas_track_plain(sym, ph0, fr0, offset=offset)
        q = slice(64 - offset if offset < 64 else 0, None)  # QPSK symbols
        for a, b in ((ko.real, po.real), (ko.imag, po.imag)):
            check(torch.equal(a[:, q] > 0, b[:, q] > 0), f"costas S={s}: hard decisions differ")
        err = (ko - po).abs().max().item()
        ph_err = (kph - pph).abs().max().item()
        if s == 192:
            check(err <= 1e-5 and ph_err <= 1e-5, f"costas S=192: err {err}, ph_end err {ph_err} > 1e-5")
        log(f"  costas S={s}: symbols within {err:.3e}, ph_end within {ph_err:.3e}, "
            f"fr_end within {(kfr - pfr).abs().max().item():.3e}")
        ms = time_ms(torch, lambda: costas_track(sym, ph0, fr0, offset=offset))
        pms = time_ms(torch, lambda: costas_track_plain(sym, ph0, fr0, offset=offset))
        record("costas", f"B={d} S={s} offset={offset}", err, ms, pms, s == 192)

    # K5 LDPC BP: noisy codewords from -6 to +4 dB, some not converging
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import reference_impl as ref

    headers = rng.integers(0, 256, (d, 4), dtype=np.uint8)
    coded = np.stack([ref.ldpc_encode_bytes(h)[:16] for h in headers])
    cw = np.unpackbits(coded, axis=1)  # [d, 128]
    snr_db = np.repeat(np.arange(-6.0, 6.0, 2.0), d // 6)[:, None]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    llr = (2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))
    llr = torch.from_numpy(llr.astype(np.float32)).to(dev)
    t = ldpc.decoder_tables()
    cv, ve = ldpc.edge_tables(t["vidx"], t["vmask"], t["h"].shape[1])
    cv, ve = torch.from_numpy(cv).to(dev), torch.from_numpy(ve).to(dev)
    h = torch.from_numpy(t["h"]).to(dev)
    ktot = ldpc_totals(llr, cv, ve)
    torch.cuda.synchronize()
    ptot = ldpc.ldpc_totals_plain(llr, cv, ve)
    kbits, kok = ldpc.finish(ktot, h)
    pbits, pok = ldpc.finish(ptot, h)
    check(torch.equal(kbits, pbits) and torch.equal(kok, pok), "ldpc: bits or ok differ")
    frac = kok.float().mean().item()
    check(0.0 < frac < 1.0, f"ldpc: every codeword converged or none did ({frac})")
    correct = (kbits.cpu().numpy() == cw[:, :32]).all(axis=1).mean()
    log(f"  ldpc: ok fraction {frac:.3f}, headers exact {correct:.3f}")
    err = (ktot - ptot).abs().max().item()
    ms = time_ms(torch, lambda: ldpc_totals(llr, cv, ve))
    pms = time_ms(torch, lambda: ldpc.ldpc_totals_plain(llr, cv, ve))
    record("ldpc", f"B={d} iters=25", err, ms, pms, True)
    return res


# ------------------------------------------------------------------ slice


def bench_signal(block: int, channels: int):
    """bench.py's stimulus: 12 x 1500-byte bursts tiled over the block,
    channel c rotated by exp(1j*0.1*c). Returns (bank samples [C, block],
    payloads in index order of the packets fully inside the block)."""
    import reference_impl as ref

    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(12)]
    bursts = [ref.burst_samples(p, packet_index=i) for i, p in enumerate(payloads)]
    stream = np.concatenate(bursts)
    reps = block // stream.size + 1
    signal = np.tile(stream, reps)[:block]
    lens = np.array([b.size for b in bursts])
    starts = (np.concatenate([[0], np.cumsum(lens)[:-1]])[None, :]
              + (np.arange(reps) * stream.size)[:, None]).ravel()
    inside = starts + np.tile(lens, reps) <= block
    expected = [payloads[i % 12] for i in np.nonzero(inside)[0]]
    rot = np.exp(1j * 0.1 * np.arange(channels))[:, None]
    return (signal[None, :] * rot).astype(np.complex64), expected


def slice_run(torch, card: str) -> dict:
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, bank_entry, entry
    from gr4_packet_modem_tpu_torch.ops import _build

    dev = torch.device("cuda")
    channels, block = BENCH_CHANNELS, BENCH_BLOCK
    step, (x,) = bank_entry(dev)
    rx = step.__self__
    fp = rx.front_pad
    samples, expected = bench_signal(block, channels)
    x[:, fp : fp + block] = torch.from_numpy(samples).to(dev)
    log(f"  bank {tuple(x.shape)} complex64, {len(expected)} packets per channel inside the block")

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    det, hdr, res, keep = step(x)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches in one bank_step: {launches}")
    for k in _build.KERNELS:
        check(launches[k] > 0, f"kernel {k} was not launched by the main path")

    check(not bool(det.overflow), "detections overflowed the slots")
    acc = res.accepted.view(channels, -1).cpu().numpy()
    lens = res.lengths.view(channels, -1).cpu().numpy()
    data = res.data.view(channels, acc.shape[1], -1).cpu().numpy()
    esn0 = det.esn0_db.view(channels, -1).cpu().numpy()
    check(int(acc.sum()) == channels * len(expected),
          f"accepted {int(acc.sum())} of {channels * len(expected)} packets")
    for c in range(channels):
        rows = np.nonzero(acc[c])[0]
        check(len(rows) == len(expected), f"channel {c}: {len(rows)} of {len(expected)} packets")
        for i, p in zip(rows, expected):
            check(lens[c, i] == p.size and np.array_equal(data[c, i, : p.size], p),
                  f"channel {c} row {i}: payload differs")
        check(np.isfinite(esn0[c, rows]).all(), f"channel {c}: non-finite esn0")
    log(f"  decoded {int(acc.sum())}/{channels * len(expected)} packets byte-exact, "
        f"esn0 {esn0[acc].min():.1f}..{esn0[acc].max():.1f} dB, "
        f"peak device memory {peak / 2**30:.2f} GiB  [{card}]")

    # rate and split by stage; every stage's outputs are consumed
    def acquire():
        d = rx.acquirer.acquire(x)
        return d.esn0_db.sum().item() + d.index.sum().item()

    def headers():
        d = rx.acquirer.acquire(x)
        df, h = rx.decode_bank(x, d, upto="headers")
        return d.esn0_db.sum().item() + h.packet_length.sum().item() + h.phase.sum().item()

    def filt():
        d = rx.acquirer.acquire(x)
        df, h, kp = rx.decode_bank(x, d, upto="filter")
        return d.esn0_db.sum().item() + h.phase.sum().item() + kp.sum().item()

    def full():
        df, h, r, kp = step(x)
        return df.esn0_db.sum().item() + r.accepted.sum().item() + r.crc_ok.sum().item()

    stages = {}
    for name, fn in (("acquire", acquire), ("+headers", headers),
                     ("+filter", filt), ("+payload", full)):
        fn()
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        stages[name] = statistics.median(times)
    rate = channels * block / (stages["+payload"] / 1e3)
    log(f"  stage times (cumulative, median of 5): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()) + f"  [{card}]")
    log(f"  rate {rate:.4e} samples/s ({channels} ch x {block} samples per step)  [{card}]")

    # the single-channel entry() step once, on three bursts it can decode
    import reference_impl as ref

    fn, (xs,) = entry(dev)
    rng = np.random.default_rng(5)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in (200, 64, 256)]
    burst = np.concatenate([ref.burst_samples(p, packet_index=i) for i, p in enumerate(pays)])
    xs[fp : fp + burst.size] = torch.from_numpy(burst.astype(np.complex64)).to(dev)
    sacc, slens, sdata = (t.cpu().numpy() for t in fn(xs))
    got = [sdata[i, : slens[i]] for i in np.nonzero(sacc)[0]]
    check(len(got) == len(pays) and all(np.array_equal(g, p) for g, p in zip(got, pays)),
          f"entry(): decoded {len(got)} of {len(pays)} packets")
    log(f"  entry(): decoded {len(got)}/{len(pays)} packets byte-exact")
    return {"launches": launches, "stages_ms": stages, "rate_sps": rate,
            "peak_bytes": peak, "packets": int(acc.sum())}


def main() -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch

    # phase 1: device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    card = smi
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build
    from gr4_packet_modem_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)}")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  {line.strip()}")

    # phase 3: kernels vs plain versions
    log("kernels:")
    kres = kernel_checks(torch, card)

    # phase 4: the slice
    log("slice:")
    sres = slice_run(torch, card)
    check("jax" not in sys.modules, "jax was imported")

    kernels = [
        {"name": k, "route": "cuda", "source": REPLACES[k][0],
         "replaces": REPLACES[k][1], "launches": sres["launches"][k],
         "max_abs_err": kres[k]["max_abs_err"], "ms": kres[k]["ms"],
         "plain_ms": kres[k]["plain_ms"]}
        for k in _build.KERNELS
    ]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "slice": sres}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
