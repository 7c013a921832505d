#!/usr/bin/env python3
"""Drive the PyTorch port's receive paths once on one NVIDIA GPU.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels (``gr4_packet_modem_tpu_torch/csrc``)
   with nvcc, one process per source, into ``build/kernels/``, and beside
   them, in parallel, the probes: ``csrc/probe/chain.cu`` (chain latency
   and an empty kernel) and ``csrc/probe/fetch_planes.cu`` (K2 as it was on
   float32 planes);
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the receive chain's shapes (K2, K2b, K4 and K5 bit for bit); time the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``: ``unfold`` and index for K2, on the
   complex bank, and K2b, the depthwise strided ``conv1d`` with TF32 off
   for K3), each as device time from torch.profiler over a loop of calls
   with the L2 evicted before each, with the host's time per call beside it
   where that is larger; K1 and K3 in turns with their yardstick; each
   kernel's bound (``bound_ms``: bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger) and, beside every row,
   the launch floor (``launch_floor_ms``: an empty kernel timed the same
   way). K2 is also timed as its callers ran it before it read the complex
   bank (two plane splits of the bank, then the plane kernel), and in turns
   with a grid-stride grid of one wave in place of its flat grid; K2b also
   with the L2 warm, as the main path finds its inputs. The recursions
   K4 and K5 are also timed at B=32 (one warp) and given a chain floor: the
   cycles of their step bodies run by one warp on registers, over the SM
   clock that ``nvidia-smi`` reads;
4. slice: ``Receiver.bank_step`` at the bench geometry (64 channels of
   2**19 samples of back-to-back 1500-byte bursts, 9 frequency bins,
   1536-byte max payload, 24 detection slots, V&V payload carrier, fused
   acquisition); every packet fully inside the block must decode
   byte-exact, and every kernel must have been launched by that run. Then
   the rate, the split by stage and the peak device memory. The same bank
   step with fft acquisition runs second and must find the same
   detections; with the Costas payload carrier third, where K4 runs the
   header and the payload pass. Then one call of the single-channel
   ``entry()`` step;
5. streaming: ``StreamingBank`` (64 channels, float32 and int8 wires) and
   ``StreamingReceiver`` fed whole 12-burst tiles as bench.py feeds them;
   every packet must come out exactly once, byte-exact, at its index, with
   no saturated block. Prints the sustained rate, the per-block host split
   and the pinned host<->device bandwidth measured in the same process.

The stimulus is made in numpy by ``gr4_packet_modem_tpu_torch/utils/
stimulus.py`` (the sequential per-packet transmitter of the tests, held bit
for bit against ``tests/reference_impl.py`` on the CPU). The last line of
output is ``{"ok": true, "device": {...}}``; the line before it lists the
kernels as JSON. Run: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

REPLACES = {
    "fetch": ("gr4_packet_modem_tpu_torch/csrc/fetch.cu",
              "gr4_packet_modem_tpu/ops/fetch_pallas.py:303"),
    "fetch_rows": ("gr4_packet_modem_tpu_torch/csrc/fetch.cu",
                   "gr4_packet_modem_tpu/ops/fetch_pallas.py:226"),
    "matched": ("gr4_packet_modem_tpu_torch/csrc/matched.cu",
                "gr4_packet_modem_tpu/ops/matched_pallas.py:133"),
    "costas": ("gr4_packet_modem_tpu_torch/csrc/costas.cu",
               "gr4_packet_modem_tpu/ops/costas_pallas.py:183"),
    "ldpc": ("gr4_packet_modem_tpu_torch/csrc/ldpc.cu",
             "gr4_packet_modem_tpu/ops/ldpc_pallas.py:139"),
    "correlate": ("gr4_packet_modem_tpu_torch/csrc/correlate.cu",
                  "gr4_packet_modem_tpu/ops/acquire_pallas.py:375"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the larger
    of ``nbytes`` over the memory rate and ``ops`` over the float32 rate."""
    tb = nbytes / PEAK_BYTES_PER_S * 1e3
    to = ops / PEAK_F32_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def event_ms(torch, fn, reps: int = 10) -> float:
    """ms per call of ``reps`` back-to-back calls between two CUDA events,
    after a warm-up call. When the host issues a call more slowly than the
    card runs it, this is the host's time."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# written between timed calls to evict the card's 50 MB L2, as triton's
# do_bench does, so each call reads its inputs from device memory
FLUSH_BYTES = 256 << 20
_flush = []


def timed(torch, fn, reps: int = 10, flush: bool = True) -> dict:
    """Per call of ``fn``: ``ms``, the device time with the L2 cold
    (torch.profiler: the time of every kernel the call launches, summed
    over ``reps`` calls, each after a write of ``FLUSH_BYTES`` whose own
    kernel is left out, divided by ``reps``, after a warm-up; with
    ``flush`` False the write is left out too, so each call finds in the
    L2 what the call before left there); ``loop_ms``,
    CUDA events around ``reps`` back-to-back calls; ``host_ms``, the host's
    time to issue one call in that loop."""
    from torch.profiler import ProfilerActivity, profile

    if not _flush:
        _flush.append(torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    scratch = _flush[0]
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    host = (time.perf_counter() - t0) * 1e3 / reps
    b.synchronize()
    loop = a.elapsed_time(b) / reps
    cuda = torch.autograd.DeviceType.CUDA
    # a profiler session now and then misses its first kernel (seen on the
    # card: a flush), so each opens with a flush of its own; it counts only
    # if each call's kernels came in whole (their number a multiple of reps)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            scratch.bitwise_not_()
            torch.cuda.synchronize()
            for _ in range(reps):
                if flush:
                    scratch.bitwise_not_()
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        flushes = sum("bitwise_not" in e.name for e in events)
        calls = [e for e in events if "bitwise_not" not in e.name]
        check(flushes <= (reps if flush else 0) + 1,
              f"{flushes} flush kernels in {reps} calls: the timed call launches their kind")
        if calls and len(calls) % reps == 0:
            break
    check(bool(calls) and len(calls) % reps == 0,
          f"the profiler saw {len(calls)} kernels of {reps} calls (and {flushes} flushes)")
    busy = sum(e.time_range.elapsed_us() for e in calls)
    return {"ms": busy / 1e3 / reps, "loop_ms": loop, "host_ms": host}


def sm_clock_mhz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout
    return float(out.splitlines()[0])


def chain_floor(torch, probe, entry: str, *args) -> dict:
    """The least time of a recursion whatever its loads do: one warp runs
    the kernel's own step body on registers (``csrc/probe/chain.cu``,
    entry ``entry``) and reads ``clock64()`` around the steps of one call.
    Returns the slowest lane's ``cycles`` (second of two calls), the SM
    clock ``nvidia-smi`` reads just after, and ``ms``, the two's ratio."""
    cycles = torch.zeros(32, dtype=torch.int64, device="cuda")
    sink = torch.zeros(32, device="cuda")
    for _ in range(2):  # the first call loads the code
        status = getattr(probe, entry)(cycles.data_ptr(), sink.data_ptr(), *args,
                                       torch.cuda.current_stream().cuda_stream)
        check(status == 0, f"{entry}: CUDA error {status}")
        torch.cuda.synchronize()
    cyc, mhz = int(cycles.max().item()), sm_clock_mhz()
    return {"cycles": cyc, "sm_mhz": mhz, "ms": cyc / (mhz * 1e3)}


def build_probe(name: str):
    """Build and load the probe ``csrc/probe/<name>.cu``, with its entry
    points' argument types."""
    import ctypes

    from gr4_packet_modem_tpu_torch.ops import _build

    P, I, I64, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib = _build.build_single(_build.CSRC / "probe" / f"{name}.cu")
    if name == "chain":
        # cycles, sink, steps, offset, stream
        lib.pm_costas_chain.argtypes = [P, P, I, I, P]
        # cycles, sink, llrs, chk_vars, var_edges, m, dmax, n, vdeg, iters, alpha, stream
        lib.pm_ldpc_chain.argtypes = [P, P, P, P, P, I, I, I, I, I, F, P]
        lib.pm_empty.argtypes = [P]
    else:
        # xr, xi, starts, outr, outi, total_len, region_len, d, stream
        lib.pm_fetch_planes.argtypes = [P, P, P, P, P, I64, I, I, P]
    return lib


# -------------------------------------------------------------- stimulus


def bench_stream():
    """bench.py's burst pattern: 12 x 1500-byte bursts back to back.
    Returns (samples, payloads, burst start offsets)."""
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, 1500, dtype=np.uint8) for _ in range(12)]
    bursts = [burst_samples(p, packet_index=i) for i, p in enumerate(payloads)]
    lens = np.array([b.size for b in bursts])
    return np.concatenate(bursts), payloads, np.concatenate([[0], np.cumsum(lens)[:-1]])


def bench_signal(block: int, channels: int):
    """bench.py's stimulus: the burst pattern tiled over the block, channel
    c rotated by exp(1j*0.1*c). Returns (bank samples [C, block], payloads
    in index order of the packets fully inside the block, their starts)."""
    stream, payloads, offsets = bench_stream()
    lens = np.diff(np.concatenate([offsets, [stream.size]]))
    reps = block // stream.size + 1
    signal = np.tile(stream, reps)[:block]
    starts = (offsets[None, :] + (np.arange(reps) * stream.size)[:, None]).ravel()
    inside = starts + np.tile(lens, reps) <= block
    expected = [payloads[i % 12] for i in np.nonzero(inside)[0]]
    rot = np.exp(1j * 0.1 * np.arange(channels))[:, None]
    return (signal[None, :] * rot).astype(np.complex64), expected, starts[inside]


# ---------------------------------------------------------------- kernels


def kernel_checks(torch, card: str, probes: dict) -> dict:
    """Each kernel against its plain version at the chain's shapes; the
    time of each, of its plain version and, where one PyTorch call computes
    the same function, of that call; each kernel's bound at its shape and
    the launch floor. K2 also by the route it replaced and on another grid;
    K4 and K5 also at B=32 and with their chain floors (``probes``: the
    libraries of ``build_probe`` by name). Launches here are comparisons:
    they do not count as the main path's."""
    import torch.nn.functional as F

    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver
    from gr4_packet_modem_tpu_torch.ops import _build, ldpc
    from gr4_packet_modem_tpu_torch.ops.acquire import AcquisitionConfig, SyncwordAcquirer
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power, fused_best_power_plain
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain
    from gr4_packet_modem_tpu_torch.ops.fetch_cuda import (
        fetch_plan, fetch_regions, fetch_regions_plain, fetch_rows, fetch_rows_plain,
    )
    from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals
    from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter, matched_filter_plain
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols, ldpc_encode_bytes

    # the yardstick convolution in full float32, as the kernel computes
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    d = 1536  # 64 channels x 24 detection slots
    res, rows = {}, []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # the launch floor: an empty kernel (one warp), timed as the kernels are
    def empty():
        check(probes["chain"].pm_empty(stream()) == 0, "pm_empty: launch failed")

    launch_floor = timed(torch, empty)["ms"]
    log(f"  launch floor (an empty kernel, timed as the kernels are): {launch_floor:.4f} ms  [{card}]")
    res["launch_floor_ms"] = launch_floor

    def record(name, shape, err, k, plain, lib, nbytes, ops, main, extra=None):
        bms, by = bound(nbytes, ops)
        host = f" (host {k['host_ms']:.4f} ms/call, loop {k['loop_ms']:.4f})" \
            if k["host_ms"] > k["ms"] or k["loop_ms"] > 1.2 * k["ms"] else ""
        libs = f"{lib:.4f} ms" if lib is not None else "none"
        log(f"  {name:10s} {shape:34s} max_abs_err={err:.3e} kernel={k['ms']:.4f} ms{host} "
            f"plain={plain:.4f} ms library={libs} bound={bms:.4f} ms ({by}, "
            f"{100 * bms / k['ms']:.1f} % of it) launch_floor_ms={launch_floor:.4f}  [{card}]")
        extra = extra or {}
        rows.append({"name": name, "shape": shape, "max_abs_err": err, **k, "plain_ms": plain,
                     "library_ms": lib, "bound_ms": bms, "bound_by": by,
                     "launch_floor_ms": launch_floor, **extra})
        r = res.setdefault(name, {"max_abs_err": 0.0})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if main:
            r.update(ms=k["ms"], plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, **extra)

    def recursion(name, shape, k, fn32, floor):
        """A recursion's time at B=32 (one warp) and its chain floor."""
        k32 = timed(torch, fn32)["ms"]
        log(f"  {name} {shape}: B=32 {k32:.4f} ms against B={d} {k['ms']:.4f} ms; chain floor "
            f"{floor['ms']:.4f} ms ({floor['cycles']} cycles at {floor['sm_mhz']:.0f} MHz, "
            f"{100 * floor['ms'] / k['ms']:.1f} % of the B={d} time)  [{card}]")
        return {"b32_ms": k32, "chain_floor_ms": floor["ms"], "chain_cycles": floor["cycles"],
                "sm_mhz": floor["sm_mhz"]}

    # K2 region fetch: the flattened 64-channel complex64 bank, starts of
    # both parities and both edge starts. Beside the kernel: the route it
    # replaced (the bank split into I and Q planes, then the plane kernel
    # of csrc/probe/fetch_planes.cu), that plane kernel alone on planes
    # split beforehand, and the kernel on a grid-stride grid of one wave
    # (8 blocks of 256 an SM) in place of the plan's flat grid
    t = 64 * 553_396
    x = torch.randn(t, generator=gen, device=dev, dtype=torch.complex64)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib2 = _build.library()
    for r in (1569, 808, 24_680):
        starts = torch.randint(0, t - r + 1, (d,), generator=gen, device=dev)
        starts[:3] = torch.tensor([0, 1, t - r])
        kr, ki = fetch_regions(x, starts, r)
        torch.cuda.synchronize()
        pr, pi = fetch_regions_plain(x, starts, r)
        check(torch.equal(kr, pr) and torch.equal(ki, pi), f"fetch R={r}: not bit-exact")
        outr, outi = torch.empty_like(pr), torch.empty_like(pi)
        planes = x.real.contiguous(), x.imag.contiguous()

        def plane_kernel(xr, xi):
            status = probes["fetch_planes"].pm_fetch_planes(
                xr.data_ptr(), xi.data_ptr(), starts.data_ptr(), outr.data_ptr(),
                outi.data_ptr(), t, r, d, stream())
            check(status == 0, f"pm_fetch_planes: CUDA error {status}")

        def parent_route():
            plane_kernel(x.real.contiguous(), x.imag.contiguous())

        def one_wave():
            blocks = min(fetch_plan(r, d)["blocks"], sms * 2048 // 256)
            status = lib2.pm_fetch_regions(x.data_ptr(), starts.data_ptr(), outr.data_ptr(),
                                           outi.data_ptr(), t, r, d, blocks, stream())
            check(status == 0, f"pm_fetch_regions: CUDA error {status}")

        for fn in (parent_route, one_wave):
            outr.zero_()
            outi.zero_()
            fn()
            torch.cuda.synchronize()
            check(torch.equal(outr, pr) and torch.equal(outi, pi), f"fetch R={r}: {fn.__name__} differs")
        del kr, ki, pr, pi
        k1 = timed(torch, lambda: fetch_regions(x, starts, r))
        w1 = timed(torch, one_wave)["ms"]
        w2 = timed(torch, one_wave)["ms"]
        k2 = timed(torch, lambda: fetch_regions(x, starts, r))
        k = {key: (k1[key] + k2[key]) / 2 for key in k1}
        pms = timed(torch, lambda: fetch_regions_plain(x, starts, r))["ms"]
        lib = timed(torch, lambda: torch.view_as_real(x).unfold(0, r, 1)[starts])["ms"]
        extra = {"parent_route_ms": timed(torch, parent_route)["ms"],
                 "plane_kernel_ms": timed(torch, lambda: plane_kernel(*planes))["ms"],
                 "one_wave_ms": (w1 + w2) / 2}
        log(f"  fetch R={r}: in turns flat grid {k1['ms']:.4f}, one-wave grid {w1:.4f}, "
            f"one-wave grid {w2:.4f}, flat grid {k2['ms']:.4f} ms; the replaced route (2 splits + "
            f"plane kernel) {extra['parent_route_ms']:.4f} ms, its plane kernel alone "
            f"{extra['plane_kernel_ms']:.4f} ms  [{card}]")
        record("fetch", f"D={d} R={r}", 0.0, k, pms, lib, 2 * (2 * d * r * 4) + d * 8, 0,
               r == 24_680, extra)
        del planes, outr, outi
    del x

    # K2b row fetch: a float32 plane of the bank's size (the bank's
    # best-power plane on the main path, where R=3), odd starts and both
    # edge starts
    plane = torch.randn(t, generator=gen, device=dev)
    for r in (3, 297, 1569):
        starts = 2 * torch.randint(0, (t - r) // 2, (d,), generator=gen, device=dev) + 1
        starts[0], starts[1] = 0, t - r
        kk = fetch_rows(plane, starts, r)
        torch.cuda.synchronize()
        check(torch.equal(kk, fetch_rows_plain(plane, starts, r)), f"fetch_rows R={r}: not bit-exact")
        k = timed(torch, lambda: fetch_rows(plane, starts, r))
        pms = timed(torch, lambda: fetch_rows_plain(plane, starts, r))["ms"]
        lib = timed(torch, lambda: plane.unfold(0, r, 1)[starts])["ms"]
        warm = timed(torch, lambda: fetch_rows(plane, starts, r), flush=False)["ms"]
        log(f"  fetch_rows R={r}: with the L2 warm (no eviction between calls) {warm:.4f} ms  [{card}]")
        record("fetch_rows", f"D={d} R={r}", 0.0, k, pms, lib, 2 * d * r * 4 + d * 8, 0, r == 3,
               {"warm_l2_ms": warm})
    del plane

    # K1 fused correlator: the bench bank (syncwords at every burst start)
    # in noise, framed by the acquirer as the main path frames it; then
    # N=4096 on a small bank. Kernel and plain version timed in turns.
    samples, _, burst_starts = bench_signal(BENCH_BLOCK, BENCH_CHANNELS)
    rx = Receiver(BENCH_CONFIG, dev)
    fp, pt = rx.front_pad, rx.pad_tail()
    cases = [("N=2048", rx.acquirer, samples, fp + burst_starts)]
    acq4 = SyncwordAcquirer(AcquisitionConfig(fft_size=4096, backend="fused"), dev)
    small = samples[:2, : 1 << 16]
    cases.append(("N=4096", acq4, small, fp + burst_starts[burst_starts < 1 << 16]))
    for label, a, sig, peaks in cases:
        c = sig.shape[0]
        x = torch.zeros(c, fp + sig.shape[1] + pt, dtype=torch.complex64, device=dev)
        x[:, fp : fp + sig.shape[1]] = torch.from_numpy(sig).to(dev)
        x += 0.05 * torch.randn(x.shape, generator=gen, device=dev, dtype=torch.complex64)
        n, s = a.config.fft_size, a.stride
        ar, ai, br, bi, nf, rows_c = a._frames_planes(x)
        args = (ar, ai, br, bi, a.replica_fft_r, a.replica_fft_i, n)
        kp, kb = fused_best_power(*args, table=a.replica_table)
        torch.cuda.synchronize()
        pp, pb = fused_best_power_plain(*args)

        def valid(v):
            return v.view(c, rows_c, n)[:, :nf, :s].reshape(c, nf * s)

        kp, kb, pp, pb = map(valid, (kp, kb, pp, pb))
        scale = pp.max().item()
        check(torch.allclose(kp, pp, rtol=1e-4, atol=1e-5 * scale),
              f"correlate {label}: best_pow beyond rtol 1e-4, atol 1e-5 x max")
        agree = (kb == pb).float().mean().item()
        check(agree >= 0.999, f"correlate {label}: best_bin equal on {agree:.6f} < 0.999")
        pk = torch.from_numpy(peaks).to(dev)
        check(torch.equal(kb[:, pk], pb[:, pk]), f"correlate {label}: best_bin differs at a syncword")
        log(f"  correlate {label}: best_bin equal on {agree:.6f} of {kb.numel()} valid samples "
            f"and at all {pk.numel() * c} syncword starts (bins {sorted(set(kb[:, pk].flatten().tolist()))})")
        err = (kp - pp).abs().max().item()
        del kp, kb, pp, pb
        k1 = timed(torch, lambda: fused_best_power(*args, table=a.replica_table))
        p1 = timed(torch, lambda: fused_best_power_plain(*args), reps=3)["ms"]
        k2 = timed(torch, lambda: fused_best_power(*args, table=a.replica_table))
        p2 = timed(torch, lambda: fused_best_power_plain(*args), reps=3)["ms"]
        log(f"  correlate {label}: in turns kernel {k1['ms']:.4f}, plain {p1:.4f}, "
            f"kernel {k2['ms']:.4f}, plain {p2:.4f} ms")
        k = {key: (k1[key] + k2[key]) / 2 for key in k1}
        fpad, nb = ar.shape[0], a.num_bins
        nbytes = 2 * (fpad + 1) * s * 4 + nb * n * 8 + fpad * n * 8
        # a frame: one forward and nb inverse transforms at the split-radix
        # count, 4 N log2 N - 6 N + 8 real operations each; then product,
        # power and max, 10 operations a point and bin
        ops = fpad * ((1 + nb) * (4 * n * np.log2(n) - 6 * n + 8) + nb * n * 10)
        record("correlate", f"C={c} FPAD={fpad} S={s} {label} nb={nb}", err, k, (p1 + p2) / 2,
               None, nbytes, ops, label == "N=2048")
        del x, ar, ai, br, bi, args

    # K3 matched filter: header (S=192) and payload (S=6160) passes; the
    # kernel and the depthwise strided conv1d in turns
    kt, sps = 44, 4
    taps = torch.randn(d, kt, generator=gen, device=dev)
    for s in (192, 6160):
        r = sps * (s - 1) + kt
        zr = torch.randn(d, r, generator=gen, device=dev)
        zi = torch.randn(d, r, generator=gen, device=dev)
        kr, ki = matched_filter(zr, zi, taps, sps, s)
        torch.cuda.synchronize()
        pr, pi = matched_filter_plain(zr, zi, taps, sps, s)

        def conv():
            w = taps.view(d, 1, kt)
            return (F.conv1d(zr.view(1, d, r), w, stride=sps, groups=d),
                    F.conv1d(zi.view(1, d, r), w, stride=sps, groups=d))

        cr, ci = conv()
        for a, b in ((kr, pr), (ki, pi), (cr[0], pr), (ci[0], pi)):
            check(torch.allclose(a, b, rtol=1e-5, atol=1e-4), f"matched S={s}: beyond rtol 1e-5 atol 1e-4")
        err = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        del pr, pi, kr, ki, cr, ci
        k1 = timed(torch, lambda: matched_filter(zr, zi, taps, sps, s))
        l1 = timed(torch, conv)["ms"]
        k2 = timed(torch, lambda: matched_filter(zr, zi, taps, sps, s))
        l2 = timed(torch, conv)["ms"]
        log(f"  matched S={s}: in turns kernel {k1['ms']:.4f}, conv1d {l1:.4f}, "
            f"kernel {k2['ms']:.4f}, conv1d {l2:.4f} ms")
        k = {key: (k1[key] + k2[key]) / 2 for key in k1}
        pms = timed(torch, lambda: matched_filter_plain(zr, zi, taps, sps, s), reps=3)["ms"]
        record("matched", f"D={d} S={s} R={r}", err, k, pms, (l1 + l2) / 2,
               2 * d * r * 4 + d * kt * 4 + 2 * d * s * 4, 2 * 2 * d * s * kt, s == 6160)
        del zr, zi

    # K4 Costas loop: a locked loop on noisy QPSK with residual CFO (the
    # regime the receiver runs it in), header and payload geometries
    for s, offset in ((192, 0), (6160, 192)):
        sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(d, s, offset, seed=7 + s))
        ko, kph, kfr = costas_track(sym, ph0, fr0, offset=offset)
        torch.cuda.synchronize()
        po, pph, pfr = costas_track_plain(sym, ph0, fr0, offset=offset)
        check(ko.is_contiguous() and po.is_contiguous(), f"costas S={s}: output not a contiguous [B, S]")
        q = slice(max(0, 64 - offset), None)  # QPSK symbols
        for a, b in ((ko.real, po.real), (ko.imag, po.imag)):
            check(torch.equal(a[:, q] > 0, b[:, q] > 0), f"costas S={s}: hard decisions differ")
        err = (ko - po).abs().max().item()
        ph_err = (kph - pph).abs().max().item()
        if s == 192:
            check(err <= 1e-5 and ph_err <= 1e-5, f"costas S=192: err {err}, ph_end err {ph_err} > 1e-5")
        same = torch.equal(ko, po) and torch.equal(kph, pph) and torch.equal(kfr, pfr)
        log(f"  costas S={s}: bit-identical to the plain version (symbols, ph_end, fr_end): {same}; "
            f"symbols within {err:.3e}, ph_end within {ph_err:.3e}, "
            f"fr_end within {(kfr - pfr).abs().max().item():.3e}")
        check(same, f"costas S={s}: not bit-identical to the plain version")
        k = timed(torch, lambda: costas_track(sym, ph0, fr0, offset=offset))
        # the plain loop issues ~20 small kernels a symbol: its loop time
        pms = event_ms(torch, lambda: costas_track_plain(sym, ph0, fr0, offset=offset),
                       reps=3 if s == 192 else 1)
        shape = f"B={d} S={s} offset={offset}"
        extra = recursion("costas", shape, k,
                          lambda: costas_track(sym[:32], ph0[:32], fr0[:32], offset=offset),
                          chain_floor(torch, probes["chain"], "pm_costas_chain", s, offset))
        # a symbol: derotation 6, error 2, loop update 5, wraps 2, and the
        # accurate cosf and sinf counted as 20 operations each
        record("costas", shape, err, k, pms, None,
               2 * d * s * 8 + 4 * d * 4, d * s * (15 + 40), s == 192, extra)
        del sym, ko, po

    # K5 LDPC BP: noisy codewords from -6 to +4 dB, some not converging
    rng = np.random.default_rng(7)
    headers = rng.integers(0, 256, (d, 4), dtype=np.uint8)
    coded = np.stack([ldpc_encode_bytes(h)[:16] for h in headers])
    cw = np.unpackbits(coded, axis=1)  # [d, 128]
    snr_db = np.repeat(np.arange(-6.0, 6.0, 2.0), d // 6)[:, None]
    sigma = np.sqrt(1.0 / (2 * 10 ** (snr_db / 10)))
    llr = (2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))
    llr = torch.from_numpy(llr.astype(np.float32)).to(dev)
    tb = ldpc.decoder_tables()
    cv, ve = ldpc.edge_tables(tb["vidx"], tb["vmask"], tb["h"].shape[1])
    edges = int((cv >= 0).sum())
    cv, ve = torch.from_numpy(cv).to(dev), torch.from_numpy(ve).to(dev)
    h = torch.from_numpy(tb["h"]).to(dev)
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
    check(torch.equal(ktot, ptot), "ldpc: totals not bit-identical to the plain version")
    err = (ktot - ptot).abs().max().item()
    k = timed(torch, lambda: ldpc_totals(llr, cv, ve))
    pms = timed(torch, lambda: ldpc.ldpc_totals_plain(llr, cv, ve), reps=3)["ms"]
    iters, alpha = 25, float(np.float32(0.75))
    shape = f"B={d} iters={iters}"
    (m, dmax), (n, vdeg) = cv.shape, ve.shape
    floor = chain_floor(torch, probes["chain"], "pm_ldpc_chain", llr.data_ptr(), cv.data_ptr(),
                        ve.data_ptr(), m, dmax, n, vdeg, iters, alpha)
    extra = recursion("ldpc", shape, k, lambda: ldpc_totals(llr[:32], cv, ve), floor)
    # an edge an iteration: the variable sum's add; the check's subtract,
    # sign, magnitude, two minima and the scaled message's two products
    record("ldpc", shape, err, k, pms, None,
           2 * d * 128 * 4, d * iters * edges * 8, True, extra)
    _flush.clear()  # so the bank step's peak device memory leaves it out
    res["rows"] = rows
    return res


# ------------------------------------------------------------------ slice


def bank_run(torch, card: str, rx, x, expected, label: str) -> dict:
    """One ``bank_step`` of ``x`` with the launch counts set to 0 just
    before it and read just after; the decode gate; then the rate, the
    split by stage and the peak device memory."""
    from gr4_packet_modem_tpu_torch.ops import _build

    channels, block = x.shape[0], x.shape[1] - rx.front_pad - rx.pad_tail()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    det, hdr, res, keep = rx.bank_step(x)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: launches in one bank_step: {launches}")

    check(not bool(det.overflow), f"{label}: detections overflowed the slots")
    acc = res.accepted.view(channels, -1).cpu().numpy()
    lens = res.lengths.view(channels, -1).cpu().numpy()
    data = res.data.view(channels, acc.shape[1], -1).cpu().numpy()
    esn0 = det.esn0_db.view(channels, -1).cpu().numpy()
    check(int(acc.sum()) == channels * len(expected),
          f"{label}: accepted {int(acc.sum())} of {channels * len(expected)} packets")
    for c in range(channels):
        rows = np.nonzero(acc[c])[0]
        check(len(rows) == len(expected), f"{label} channel {c}: {len(rows)} of {len(expected)} packets")
        for i, p in zip(rows, expected):
            check(lens[c, i] == p.size and np.array_equal(data[c, i, : p.size], p),
                  f"{label} channel {c} row {i}: payload differs")
        check(np.isfinite(esn0[c, rows]).all(), f"{label} channel {c}: non-finite esn0")
    log(f"  {label}: decoded {int(acc.sum())}/{channels * len(expected)} packets byte-exact, "
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
        df, h, r, kp = rx.bank_step(x)
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
    log(f"  {label}: stage times (cumulative, median of 5): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()) + f"  [{card}]")
    log(f"  {label}: rate {rate:.4e} samples/s ({channels} ch x {block} samples per step)  [{card}]")
    return {"det": det, "launches": launches, "stages_ms": stages, "rate_sps": rate,
            "peak_bytes": peak, "packets": int(acc.sum())}


def slice_run(torch, card: str) -> dict:
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG, bank_entry, entry
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver
    from gr4_packet_modem_tpu_torch.ops import _build

    dev = torch.device("cuda")
    channels, block = BENCH_CHANNELS, BENCH_BLOCK
    step, (x,) = bank_entry(dev)
    rx = step.__self__
    check(rx.acquirer.backend == "fused", f"bench acquisition runs {rx.acquirer.backend}, not fused")
    fp = rx.front_pad
    samples, expected, _ = bench_signal(block, channels)
    x[:, fp : fp + block] = torch.from_numpy(samples).to(dev)
    log(f"  bank {tuple(x.shape)} complex64, {len(expected)} packets per channel inside the block")

    fused = bank_run(torch, card, rx, x, expected, "fused")
    for k in _build.KERNELS:
        check(fused["launches"][k] > 0, f"kernel {k} was not launched by the main path")

    # the fft backend as the second path, on the same bank
    rx_fft = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_backend="fft"), dev)
    fft = bank_run(torch, card, rx_fft, x, expected, "fft")
    check(fft["launches"]["correlate"] == 0, "the fft path launched the fused correlator")
    for k in _build.KERNELS:
        check(k == "correlate" or fft["launches"][k] > 0, f"kernel {k} was not launched by the fft path")
    a, b = fused.pop("det"), fft.pop("det")
    v = b.valid
    check(torch.equal(a.valid, v), "fused and fft detections differ in valid")
    for f in ("index", "freq_bin"):
        check(torch.equal(getattr(a, f)[v], getattr(b, f)[v]), f"fused and fft detections differ in {f}")
    log(f"  fused and fft detections equal on all {int(v.sum())} valid rows (index, valid, freq_bin)")
    del rx_fft

    # the Costas payload carrier (RxConfig's own default) on the same bank,
    # fused acquisition, one plain batch: K4 runs the header and the
    # payload pass
    rx_costas = Receiver(dataclasses.replace(BENCH_CONFIG, payload_carrier="costas"), dev)
    costas = bank_run(torch, card, rx_costas, x, expected, "costas")
    costas.pop("det")
    check(costas["launches"]["costas"] == 2,
          f"costas carrier: K4 launched {costas['launches']['costas']} times in one step, not 2")
    for k in _build.KERNELS:
        check(costas["launches"][k] > 0, f"kernel {k} was not launched by the Costas carrier's step")
    log(f"  costas carrier against V&V: +payload {costas['stages_ms']['+payload']:.2f} against "
        f"{fused['stages_ms']['+payload']:.2f} ms, rate {costas['rate_sps']:.4e} against "
        f"{fused['rate_sps']:.4e} samples/s  [{card}]")
    del rx_costas

    # the single-channel entry() step once, on three bursts it can decode
    from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples

    fn, (xs,) = entry(dev)
    rng = np.random.default_rng(5)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in (200, 64, 256)]
    burst = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(pays)])
    xs[fp : fp + burst.size] = torch.from_numpy(burst.astype(np.complex64)).to(dev)
    sacc, slens, sdata = (t.cpu().numpy() for t in fn(xs))
    got = [sdata[i, : slens[i]] for i in np.nonzero(sacc)[0]]
    check(len(got) == len(pays) and all(np.array_equal(g, p) for g, p in zip(got, pays)),
          f"entry(): decoded {len(got)} of {len(pays)} packets")
    log(f"  entry(): decoded {len(got)}/{len(pays)} packets byte-exact")
    return {"fused": fused, "fft": fft, "costas": costas}


# -------------------------------------------------------------- streaming


def pinned_bandwidth(torch, nbytes: int = 1 << 28) -> tuple[float, float]:
    """(h2d, d2h) bytes/s of pinned host <-> device copies (CUDA events
    around 10 copies)."""
    h = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    d = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    h2d = event_ms(torch, lambda: d.copy_(h, non_blocking=True))
    d2h = event_ms(torch, lambda: h.copy_(d, non_blocking=True))
    return nbytes / (h2d / 1e3), nbytes / (d2h / 1e3)


def stream_run(torch, card: str, driver, x_unit, expected, units: int, label: str) -> dict:
    """bench.py's feed: one warm-up unit, ``units`` timed units, drain,
    flush. The gate: every packet exactly once, byte-exact, at its index,
    and no saturated block. The launch counts are set to 0 before the feed
    and read after it."""
    from gr4_packet_modem_tpu_torch.ops import _build

    _build.reset_launch_counts()
    pkts = driver.process(x_unit)
    blocks0, stats0 = driver.stats["blocks"], dict(driver.stats)
    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as syncs:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        for _ in range(units):
            pkts += driver.process(x_unit)
        pkts += driver._drain()
        dt = time.perf_counter() - t0
    torch.cuda.set_sync_debug_mode("default")
    blocks = driver.stats["blocks"] - blocks0
    stats1 = dict(driver.stats)
    pkts += driver.flush()
    launches = _build.launch_counts()

    channels = driver.channels
    check(driver.overflow_blocks == 0 and driver.budget_overflow_blocks == 0,
          f"{label}: {driver.overflow_blocks} overflow and {driver.budget_overflow_blocks} budget-overflow blocks")
    check(len(pkts) == channels * len(expected),
          f"{label}: {len(pkts)} packets, expected {channels * len(expected)}")
    for c in range(channels):
        got = sorted((p for p in pkts if p.channel == c), key=lambda p: p.index)
        check([p.index for p in got] == [i for i, _ in expected], f"{label} channel {c}: indices differ")
        check(all(np.array_equal(p.data, e) for p, (_, e) in zip(got, expected)),
              f"{label} channel {c}: a payload differs")
    check(launches["correlate"] > 0, f"{label}: the fused correlator was not launched")
    rate = blocks * driver.block * channels / dt
    per_block = {k: 1e3 * (stats1[k] - stats0[k]) / blocks for k in ("h2d_s", "dispatch_s", "materialize_s")}
    sync_msgs = sorted({str(w.message).splitlines()[0] for w in syncs if "synchroniz" in str(w.message)})
    log(f"  {label}: {len(pkts)}/{channels * len(expected)} packets exactly once, byte-exact, at their "
        f"indices; sustained {rate:.4e} samples/s over {blocks} blocks; per block h2d "
        f"{per_block['h2d_s']:.2f} ms, dispatch {per_block['dispatch_s']:.2f} ms, materialize "
        f"{per_block['materialize_s']:.2f} ms  [{card}]")
    log(f"  {label}: launches {launches}; synchronising calls in the timed feed: "
        f"{sum('synchroniz' in str(w.message) for w in syncs)} {sync_msgs[:3]}")
    return {"rate_sps": rate, "blocks": blocks, "per_block_ms": per_block, "launches": launches,
            "packets": len(pkts)}


def streaming_phase(torch, card: str) -> dict:
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank, StreamingReceiver

    dev = torch.device("cuda")
    block, channels, units = BENCH_BLOCK, BENCH_CHANNELS, 3
    stream, payloads, offsets = bench_stream()
    reps = -(-block // stream.size)
    unit = np.tile(stream, reps)  # whole bursts only (bench.py:184-186)
    starts = (offsets[None, :] + (np.arange(reps) * stream.size)[:, None]).ravel()
    expected = [(u * unit.size + s, payloads[i % 12])
                for u in range(1 + units) for i, s in enumerate(starts)]
    x_unit = (unit[None, :] * np.exp(1j * 0.1 * np.arange(channels))[:, None]).astype(np.complex64)
    h2d, d2h = pinned_bandwidth(torch)
    log(f"  pinned copies: h2d {h2d / 1e9:.3f} GB/s, d2h {d2h / 1e9:.3f} GB/s  [{card}]")
    out = {"h2d_Bps": h2d, "d2h_Bps": d2h}
    budget = BENCH_CONFIG.max_detections  # per channel: bench.py's "auto" budget
    for name, wire, nbytes in (("bank_f32", None, 8), ("bank_int8", torch.int8, 2)):
        bank = StreamingBank(BENCH_CONFIG, dev, channels=channels, block=block, group=16,
                             transfer_dtype=wire, result_budget=budget * channels)
        r = stream_run(torch, card, bank, x_unit, expected, units, f"StreamingBank {name[5:]}")
        r["h2d_share"] = r["rate_sps"] * nbytes / h2d
        log(f"  StreamingBank {name[5:]}: wire {nbytes} B/sample = {r['rate_sps'] * nbytes / 1e9:.3f} GB/s, "
            f"{100 * r['h2d_share']:.1f} % of the pinned h2d bandwidth  [{card}]")
        out[name] = r
        del bank
    srx = StreamingReceiver(BENCH_CONFIG, dev, block=block, result_budget=budget)
    r = stream_run(torch, card, srx, unit.astype(np.complex64), expected, units, "StreamingReceiver f32")
    r["h2d_share"] = r["rate_sps"] * 8 / h2d
    out["receiver_f32"] = r
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gr4_packet_modem_tpu_torch")):
        raise SystemExit("chip_smoke: gr4_packet_modem_tpu_torch/ is missing: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
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
    with ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(build_probe, name) for name in ("chain", "fetch_planes")}
        path = _build.build()
        probes = {name: job.result() for name, job in jobs.items()}
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)} and the probes")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  {line.strip()}")

    # phase 3: kernels vs plain versions
    log("kernels:")
    kres = kernel_checks(torch, card, probes)

    # phase 4: the slice
    log("slice:")
    sres = slice_run(torch, card)

    # phase 5: the streaming drivers
    log("streaming:")
    stres = streaming_phase(torch, card)
    check("jax" not in sys.modules, "jax was imported")
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "gr4_packet_modem_tpu")
    check(not jax_package, f"modules of the JAX package were imported: {jax_package}")

    main_launches = sres["fused"]["launches"]
    kernels = [
        {"name": k, "route": "cuda", "source": REPLACES[k][0],
         "replaces": REPLACES[k][1], "launches": main_launches[k],
         **{f: kres[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")}}
        for k in _build.KERNELS
    ]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "kernel_rows": kres["rows"],
                   "launch_floor_ms": kres["launch_floor_ms"], "slice": sres,
                   "streaming": stres}, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
