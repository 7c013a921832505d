#!/usr/bin/env python3
"""Drive the PyTorch port's receive and transmit paths once on one NVIDIA
GPU.

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
   acquisition) as one batch (``group=0``); every packet fully inside the
   block must decode byte-exact, and every kernel must have been launched
   by that run. Then the rate, the split by stage and the peak device
   memory. The same step in channel groups of 16 (``bank_step``'s default)
   must give the same detections, flags and bytes. The bank step with fft
   acquisition runs next and must find the same detections; then the
   Costas payload carrier, where K4 runs the header and the payload pass,
   at group 0 and at group 16 (the ``ch64_costas_g16`` configuration),
   the two equal. Then one call of the single-channel ``entry()`` step;
5. streaming: ``StreamingBank`` (64 channels, float32 and int8 wires) and
   ``StreamingReceiver`` fed whole 12-burst tiles as bench.py feeds them;
   every packet must come out exactly once, byte-exact, at its index, with
   no saturated block. Prints the sustained rate, the per-block host split
   and the pinned host<->device bandwidth measured in the same process;
6. taps: one ``StreamingReceiver`` with list sinks as header and payload
   taps: every accepted packet sends 128 header symbols and ``4*(len+4)``
   payload symbols, each message with MER above 20 dB;
7. TX: ``tx_entry`` in burst and stream mode at 64 x 1500 bytes, with
   PyTorch's default TF32 flags (phase 3's yardstick turns cuDNN's off and
   restores it); the card's samples within 1e-5 of the same transmitter on
   CPU tensors, lengths equal; samples/s from CUDA events over a loop,
   with the host's time per call beside it;
8. transceiver: ``transceiver_entry`` (24 x 1500-byte bursts, CFO 0.005,
   noise 0.05, 4 frequency bins a side) must decode 24/24 byte-exact;
   samples/s of the step and its split into TX, channel and RX. Then a
   stream-mode loopback (14 packets of 10..1500 bytes, CFO 0.006) and the
   SFO operating point (1.2 ppm, CFO 0.005), each decoding every packet;
9. per: ``entry.per_curve`` (42 rows of 24 random 200-byte packets, 1008
   a point) at 20, 13, 12, 11, 10 and 8 dB with the Costas carrier and at
   11 and 20 dB with V&V, beside the uncoded-QPSK PER; gates: 0 at 20 dB,
   Costas in [0.21, 0.34] at 11 dB, above 0.9 at 8 dB, non-increasing in
   Es/N0 within 3 sigma a step, every point within 3 binomial sigma of the
   theory, the carriers within 0.06 at 11 dB, and the
   same numpy-made noisy samples (240 packets at 11 dB) decoded alike on
   CPU tensors and on the card but for at most one packet;
10. sharded: NCCL at world 1 and a 1 x 1 ``make_mesh``: ``StreamingShardedBank``
   beside ``StreamingBank`` (int8 wire, the streaming stimulus; the same
   packets in order, rates and host split side by side), one
   ``ReceiverBank.step`` of the bench bank in channel groups of 16 (rows
   equal to ``bank_step(x, 16)``'s), ``entry.sharded_dryrun``; with two
   cards or more also one process a card on a ``(ch, 2)`` mesh, held to
   ``StreamingBank``'s packets.

Each path runs with the launch counts set to 0 just before it and read
just after; each path of the receiver must have launched every kernel.

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


def loop_ms(torch, fn, reps: int = 10) -> tuple[float, float]:
    """(device ms, host ms) per call of ``reps`` back-to-back calls after a
    warm-up: CUDA events around the loop, and the host's time to issue
    one call."""
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
    return a.elapsed_time(b) / reps, host


def median_ms(torch, fn, reps: int = 5) -> float:
    """Median host time of ``reps`` calls, each ending in a synchronise,
    after a warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def busy_ms(torch, fn, reps: int = 5) -> tuple[float, float]:
    """(device busy ms, device operations) per call: torch.profiler's CUDA
    events (kernels and copies) of ``reps`` back-to-back calls after a
    warm-up, summed and divided by ``reps``; the L2 is left as the calls
    leave it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(events), "the profiler saw no device work")
    return sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps, len(events) / reps


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
    loop, host = loop_ms(torch, fn, reps)
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
    # the yardstick convolution in full float32, as the kernel computes;
    # the flag is restored for the later phases
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _kernel_checks(torch, card, probes)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _kernel_checks(torch, card: str, probes: dict) -> dict:
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


def bank_run(torch, card: str, rx, x, expected, label: str, group: int = 0):
    """One ``bank_step(x, group)`` with the launch counts set to 0 just
    before it and read just after; the decode gate; then the rate, the
    peak device memory and, for one batch (``group=0``), the split by
    stage. Returns the numbers and the step's ``(det, res, keep)``."""
    from gr4_packet_modem_tpu_torch.ops import _build

    channels, block = x.shape[0], x.shape[1] - rx.front_pad - rx.pad_tail()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    det, hdr, res, keep = rx.bank_step(x, group)
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
        df, h, r, kp = rx.bank_step(x, group)
        return df.esn0_db.sum().item() + r.accepted.sum().item() + r.crc_ok.sum().item()

    stages = (("acquire", acquire), ("+headers", headers), ("+filter", filt), ("+payload", full))
    stages = {name: median_ms(torch, fn) for name, fn in stages[0 if group == 0 else 3:]}
    rate = channels * block / (stages["+payload"] / 1e3)
    log(f"  {label}: stage times (cumulative, median of 5): "
        + ", ".join(f"{k} {v:.2f} ms" for k, v in stages.items()) + f"  [{card}]")
    log(f"  {label}: rate {rate:.4e} samples/s ({channels} ch x {block} samples per step), "
        f"group {group}  [{card}]")
    return {"launches": launches, "stages_ms": stages, "rate_sps": rate, "group": group,
            "peak_bytes": peak, "packets": int(acc.sum())}, (det, res, keep)


def same_rows(torch, a, b, label: str) -> None:
    """Two bank steps' ``(det, res, keep)`` give equal detections (index,
    valid, freq_bin, overflow), flags and bytes."""
    (da, ra, ka), (db, rb, kb) = a, b
    for f in ("index", "valid", "freq_bin", "overflow"):
        check(torch.equal(getattr(da, f), getattr(db, f)), f"{label}: detections differ in {f}")
    for f in ("accepted", "crc_ok", "lengths", "data"):
        check(torch.equal(getattr(ra, f), getattr(rb, f)), f"{label}: results differ in {f}")
    check(torch.equal(ka, kb), f"{label}: keep differs")
    log(f"  {label}: equal detections, keep, accepted, crc_ok, lengths and bytes on all "
        f"{da.index.numel()} rows")



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

    fused, fused_rows = bank_run(torch, card, rx, x, expected, "fused")
    for k in _build.KERNELS:
        check(fused["launches"][k] > 0, f"kernel {k} was not launched by the main path")
    # channel groups of 16 (bank_step's default): four groups, one after another
    fused16, rows16 = bank_run(torch, card, rx, x, expected, "fused group 16", group=16)
    for k in _build.KERNELS:
        check(fused16["launches"][k] > 0, f"kernel {k} was not launched by the group-16 step")
    same_rows(torch, rows16, fused_rows, "fused group 16 against group 0")
    del rows16

    # the fft backend as the second path, on the same bank
    rx_fft = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_backend="fft"), dev)
    fft, fft_rows = bank_run(torch, card, rx_fft, x, expected, "fft")
    check(fft["launches"]["correlate"] == 0, "the fft path launched the fused correlator")
    for k in _build.KERNELS:
        check(k == "correlate" or fft["launches"][k] > 0, f"kernel {k} was not launched by the fft path")
    a, b = fused_rows[0], fft_rows[0]
    v = b.valid
    check(torch.equal(a.valid, v), "fused and fft detections differ in valid")
    for f in ("index", "freq_bin"):
        check(torch.equal(getattr(a, f)[v], getattr(b, f)[v]), f"fused and fft detections differ in {f}")
    log(f"  fused and fft detections equal on all {int(v.sum())} valid rows (index, valid, freq_bin)")
    del rx_fft, fused_rows, fft_rows, a, b

    # the Costas payload carrier (RxConfig's own default) on the same bank,
    # fused acquisition: K4 runs the header and the payload pass. One
    # batch, then groups of 16 (the ch64_costas_g16 configuration)
    rx_costas = Receiver(dataclasses.replace(BENCH_CONFIG, payload_carrier="costas"), dev)
    costas, costas_rows = bank_run(torch, card, rx_costas, x, expected, "costas")
    check(costas["launches"]["costas"] == 2,
          f"costas carrier: K4 launched {costas['launches']['costas']} times in one step, not 2")
    for k in _build.KERNELS:
        check(costas["launches"][k] > 0, f"kernel {k} was not launched by the Costas carrier's step")
    log(f"  costas carrier against V&V: +payload {costas['stages_ms']['+payload']:.2f} against "
        f"{fused['stages_ms']['+payload']:.2f} ms, rate {costas['rate_sps']:.4e} against "
        f"{fused['rate_sps']:.4e} samples/s  [{card}]")
    costas16, rows16 = bank_run(torch, card, rx_costas, x, expected, "costas group 16", group=16)
    check(costas16["launches"]["costas"] == 8,
          f"costas group 16: K4 launched {costas16['launches']['costas']} times, not 2 a group")
    for k in _build.KERNELS:
        check(costas16["launches"][k] > 0, f"kernel {k} was not launched by the Costas group-16 step")
    same_rows(torch, rows16, costas_rows, "costas group 16 against group 0")
    for name, g16, g0 in (("V&V", fused16, fused), ("costas", costas16, costas)):
        log(f"  {name} group 16 against group 0: {g16['stages_ms']['+payload']:.2f} against "
            f"{g0['stages_ms']['+payload']:.2f} ms, peak device memory {g16['peak_bytes'] / 2**30:.2f} "
            f"against {g0['peak_bytes'] / 2**30:.2f} GiB  [{card}]")
    del rx_costas, costas_rows, rows16

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
    return {"fused": fused, "fused_g16": fused16, "fft": fft, "costas": costas,
            "costas_g16": costas16}


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
    n_syncs = sum("synchroniz" in str(w.message) for w in syncs)
    log(f"  {label}: launches {launches}; synchronising calls in the timed feed: {n_syncs} {sync_msgs[:3]}")
    return {"rate_sps": rate, "blocks": blocks, "per_block_ms": per_block, "launches": launches,
            "packets": len(pkts), "syncs": n_syncs}, pkts


def stream_stimulus(block: int, channels: int, units: int):
    """bench.py's streaming feed: whole 12-burst tiles (bench.py:184-186),
    channel c rotated by exp(1j*0.1*c). Returns (one unit [C, n], the
    (index, payload) of every packet of 1 + ``units`` units)."""
    stream, payloads, offsets = bench_stream()
    reps = -(-block // stream.size)
    unit = np.tile(stream, reps)
    starts = (offsets[None, :] + (np.arange(reps) * stream.size)[:, None]).ravel()
    expected = [(u * unit.size + s, payloads[i % 12])
                for u in range(1 + units) for i, s in enumerate(starts)]
    x_unit = (unit[None, :] * np.exp(1j * 0.1 * np.arange(channels))[:, None]).astype(np.complex64)
    return x_unit, expected


def streaming_phase(torch, card: str) -> dict:
    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank, StreamingReceiver

    dev = torch.device("cuda")
    block, channels, units = BENCH_BLOCK, BENCH_CHANNELS, 3
    x_unit, expected = stream_stimulus(block, channels, units)
    h2d, d2h = pinned_bandwidth(torch)
    log(f"  pinned copies: h2d {h2d / 1e9:.3f} GB/s, d2h {d2h / 1e9:.3f} GB/s  [{card}]")
    out = {"h2d_Bps": h2d, "d2h_Bps": d2h}
    budget = BENCH_CONFIG.max_detections  # per channel: bench.py's "auto" budget
    for name, wire, nbytes in (("bank_f32", None, 8), ("bank_int8", torch.int8, 2)):
        bank = StreamingBank(BENCH_CONFIG, dev, channels=channels, block=block, group=16,
                             transfer_dtype=wire, result_budget=budget * channels)
        r, _ = stream_run(torch, card, bank, x_unit, expected, units, f"StreamingBank {name[5:]}")
        r["h2d_share"] = r["rate_sps"] * nbytes / h2d
        log(f"  StreamingBank {name[5:]}: wire {nbytes} B/sample = {r['rate_sps'] * nbytes / 1e9:.3f} GB/s, "
            f"{100 * r['h2d_share']:.1f} % of the pinned h2d bandwidth  [{card}]")
        out[name] = r
        del bank
    srx = StreamingReceiver(BENCH_CONFIG, dev, block=block, result_budget=budget)
    r, _ = stream_run(torch, card, srx, x_unit[0], expected, units, "StreamingReceiver f32")
    r["h2d_share"] = r["rate_sps"] * 8 / h2d
    out["receiver_f32"] = r
    return out


# ------------------------------------------------------------ taps, TX, transceiver

LOOPBACK_LENGTHS = [10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34]


class ListSink:
    """A tap sink that keeps its messages."""

    def __init__(self):
        self.msgs = []

    def send(self, pdu):
        self.msgs.append(np.asarray(pdu))


def path_launches(torch, label: str, fn, need=()):
    """Run ``fn`` with the launch counts set to 0 just before it and read
    just after; every kernel named in ``need`` must have been launched."""
    from gr4_packet_modem_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    log(f"  {label}: launches {launches}")
    for k in need:
        check(launches[k] > 0, f"kernel {k} was not launched by {label}")
    return out, launches


def decoded(res) -> list[np.ndarray]:
    acc, lens, data = (t.cpu().numpy() for t in (res.accepted, res.lengths, res.data))
    return [data[i, : lens[i]] for i in np.nonzero(acc)[0]]


def check_all(got, payloads, label: str) -> None:
    check(len(got) == len(payloads), f"{label}: decoded {len(got)} of {len(payloads)} packets")
    for i, (g, p) in enumerate(zip(got, payloads)):
        check(np.array_equal(g, p), f"{label}: packet {i} differs")
    log(f"  {label}: decoded {len(got)}/{len(payloads)} packets byte-exact")


def taps_phase(torch, card: str, dev) -> dict:
    """``StreamingReceiver`` with list sinks as its header and payload taps,
    on bursts from the port's transmitter on the card."""
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingReceiver, StreamingTransmitter

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from plot_symbols import mer_db  # the monitor's MER: signal over error-vector power

    payloads = [(np.arange(n) % 256).astype(np.uint8) for n in (100, 1500, 200, 37)]
    sig = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=1536), dev)).send_burst(payloads)
    hdr, pay = ListSink(), ListSink()
    srx = StreamingReceiver(RxConfig(max_payload_len=1536, max_detections=8), dev, block=1 << 16,
                            header_tap=hdr, payload_tap=pay)
    pkts, launches = path_launches(torch, "taps", lambda: srx.process(sig) + srx.flush(), _build.KERNELS)
    check_all([p.data for p in pkts], payloads, "taps")
    check([m.size for m in hdr.msgs] == [128] * len(payloads), f"taps: header messages {[m.size for m in hdr.msgs]}")
    want = [4 * (p.size + 4) for p in payloads]
    check([m.size for m in pay.msgs] == want, f"taps: payload messages {[m.size for m in pay.msgs]}, not {want}")
    mers = [mer_db(m) for m in hdr.msgs + pay.msgs]
    check(all(m.dtype == np.complex64 for m in hdr.msgs + pay.msgs), "taps: a message is not complex64")
    check(min(mers) > 20.0, f"taps: MER {min(mers):.1f} dB <= 20 dB")
    log(f"  taps: {len(hdr.msgs)} header and {len(pay.msgs)} payload messages, MER "
        f"{min(mers):.1f}..{max(mers):.1f} dB  [{card}]")
    return {"launches": launches, "mer_db": [min(mers), max(mers)]}


def tx_phase(torch, card: str, dev, tf32_defaults: tuple) -> dict:
    """``tx_entry`` on the card against the same entry on CPU tensors, then
    its rate."""
    from gr4_packet_modem_tpu_torch.entry import tx_entry

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    check(flags == tf32_defaults, f"TX: TF32 flags {flags}, not the defaults {tf32_defaults}")
    log(f"  TF32 flags (cuBLAS, cuDNN) at PyTorch's defaults: {flags}")
    out = {}
    for mode in ("burst", "stream"):
        fn, (b,) = tx_entry(dev, stream=mode == "stream")
        (samples, lens), launches = path_launches(torch, f"tx_{mode}", lambda: fn(b))
        cfn, (cb,) = tx_entry("cpu", stream=mode == "stream")
        want, want_lens = cfn(cb)
        check(torch.equal(lens.cpu(), want_lens), f"tx_{mode}: lengths differ from the CPU's")
        err = (samples.cpu() - want).abs().max().item()
        check(err <= 1e-5, f"tx_{mode}: samples {err:.3e} from the CPU's (> 1e-5)")
        n = int(lens.sum())  # the bursts' own samples, as the benchmark counts them
        ms, host = loop_ms(torch, lambda: fn(b), reps=20)
        busy, ops = busy_ms(torch, lambda: fn(b))
        log(f"  tx_{mode}: {b.batch} x 1500 B -> {n} samples, max |card - CPU| {err:.3e}; "
            f"{ms:.4f} ms a call (CUDA events over 20 calls), host {host:.4f} ms a call, "
            f"device busy {busy:.4f} ms in {ops:.0f} operations a call, "
            f"{n / (ms / 1e3):.4e} samples/s  [{card}]")
        out[f"tx_{mode}"] = {"samples": n, "max_abs_err": err, "ms": ms, "host_ms": host,
                             "busy_ms": busy, "device_ops": ops,
                             "samples_per_s": n / (ms / 1e3), "launches": launches}
    return out


def transceiver_phase(torch, card: str, dev) -> dict:
    """``transceiver_entry`` (24 x 1500 B, 4 bins a side): decode gate,
    rate and split; then a stream-mode loopback and the SFO operating
    point."""
    from gr4_packet_modem_tpu_torch.entry import transceiver_entry
    from gr4_packet_modem_tpu_torch.models.channel import awgn, rotate, sfo
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.utils import constants as C
    from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat

    fn, (packets, gen) = transceiver_entry(dev, bins=4, batch=24)
    (n, res), launches = path_launches(torch, "transceiver_4bins", lambda: fn(packets, gen), _build.KERNELS)
    check(int(n) == 24, f"transceiver_4bins: accepted {int(n)} of 24")
    check_all(decoded(res), packets.to_list(), "transceiver_4bins")
    stream = fn.transmit(packets)
    x = fn.channel(stream, gen)
    split = {
        "step": median_ms(torch, lambda: fn(packets, gen)[0].item()),
        "tx": median_ms(torch, lambda: fn.transmit(packets)),
        "channel": median_ms(torch, lambda: fn.channel(stream, gen)),
        "rx": median_ms(torch, lambda: fn.receive(x).accepted.sum().item()),
    }
    rate = fn.total / (split["step"] / 1e3)
    busy = {name: busy_ms(torch, f) for name, f in (
        ("step", lambda: fn(packets, gen)), ("tx", lambda: fn.transmit(packets)),
        ("channel", lambda: fn.channel(stream, gen)), ("rx", lambda: fn.receive(x)))}
    log(f"  transceiver_4bins: {fn.total} samples a step, {rate:.4e} samples/s; median of 5: step "
        f"{split['step']:.2f} ms = TX {split['tx']:.2f} + channel {split['channel']:.2f} + RX "
        f"{split['rx']:.2f} ms  [{card}]")
    log("  transceiver_4bins: device busy (ms, operations) a call: "
        + ", ".join(f"{k} {v[0]:.3f} in {v[1]:.0f}" for k, v in busy.items()) + f"  [{card}]")
    out = {"transceiver_4bins": {"launches": launches, "ms": split, "samples_per_s": rate,
                                 "samples": fn.total, "busy_ms": {k: v[0] for k, v in busy.items()},
                                 "device_ops": {k: v[1] for k, v in busy.items()}}}

    payloads = [(np.arange(m) % 256).astype(np.uint8) for m in LOOPBACK_LENGTHS]
    batch = PacketBatch.from_list(payloads, 1536, dev)
    rx = fn.rx
    g = torch.Generator(device=dev).manual_seed(2)

    def stream_loopback():
        tx = Transmitter(TxConfig(max_payload_len=1536, stream_mode=True), dev)
        syms = sum(C.stream_symbols(p.size) for p in payloads) + 16  # FIR flush
        return rx.receive(awgn(rotate(tx.modulate_stream(batch, syms)[1], 0.006), 0.05, g))

    def sfo_loopback():
        samples, lens = fn.tx.modulate_bursts(batch)
        burst = ragged_concat(samples, lens, 4 * sum(C.burst_symbols(p.size) for p in payloads))[0]
        return rx.receive(awgn(rotate(sfo(burst, 1.2), 0.005), 0.05, g))

    for label, run in (("loopback stream CFO 0.006", stream_loopback),
                       ("loopback SFO 1.2 ppm CFO 0.005", sfo_loopback)):
        res, launches = path_launches(torch, label, run, _build.KERNELS)
        check_all(decoded(res), payloads, label)
        out[label] = {"launches": launches, "packets": len(payloads)}
    return out


# -------------------------------------------------------------- PER, sharded

PER_POINTS = (20.0, 13.0, 12.0, 11.0, 10.0, 8.0)


def qpsk_per_theory(esn0_db: float, bits: int = 8 * (200 + 4)) -> float:
    """Uncoded QPSK PER of a 204-byte packet: 1 - (1 - Q(sqrt(Es/N0)))^1632."""
    from math import erfc, sqrt

    ber = 0.5 * erfc(sqrt(10 ** (esn0_db / 10)) / sqrt(2))
    return 1.0 - (1.0 - ber) ** bits


def per_phase(torch, card: str, dev) -> dict:
    """``per_curve`` on the card (1008 packets a point, Costas at six
    points and V&V at two) against the uncoded-QPSK theory, with its gates;
    then the same numpy-made noisy samples (240 packets at 11 dB) through
    the receiver on CPU tensors and on the card."""
    from gr4_packet_modem_tpu_torch.entry import per_config, per_curve, per_decode, per_sets, per_signal
    from gr4_packet_modem_tpu_torch.models.channel import esn0_db_to_noise_sigma
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver
    from gr4_packet_modem_tpu_torch.ops import _build

    curves = {}
    for carrier, points in (("costas", PER_POINTS), ("vv", (11.0, 20.0))):
        t0 = time.perf_counter()
        curves[carrier], launches = path_launches(
            torch, f"per {carrier}", lambda: per_curve(dev, points, carrier=carrier), _build.KERNELS)
        log(f"  per {carrier}: {len(points)} points in {time.perf_counter() - t0:.2f} s  [{card}]")
        for p in curves[carrier]:
            log(f"  per {carrier} Es/N0 {p['esn0_db']:5.1f} dB: PER {p['per']:.4f} ({p['good']}/{p['packets']} "
                f"good, crc_ok {p['crc_ok']}), uncoded QPSK theory {qpsk_per_theory(p['esn0_db']):.4f}  [{card}]")
    by = {c: {p["esn0_db"]: p for p in pts} for c, pts in curves.items()}
    n = by["costas"][20.0]["packets"]
    check(n == 1008, f"per: {n} packets a point, not 1008")
    check(by["costas"][20.0]["per"] == 0.0 and by["vv"][20.0]["per"] == 0.0, "per: packets lost at 20 dB")
    mid = by["costas"][11.0]["per"]
    check(0.21 <= mid <= 0.34, f"per: Costas PER {mid:.4f} at 11 dB outside [0.21, 0.34]")
    check(by["costas"][8.0]["per"] > 0.9, f"per: PER {by['costas'][8.0]['per']:.4f} at 8 dB, not above 0.9")
    pers = [by["costas"][e]["per"] for e in PER_POINTS]  # Es/N0 falling
    for e, a, b in zip(PER_POINTS[1:], pers, pers[1:]):
        sigma = np.sqrt((a * (1 - a) + b * (1 - b)) / n)
        check(b >= a - 3 * sigma, f"per: PER falls from {a:.4f} to {b:.4f} as Es/N0 falls to {e} dB")
    diff = abs(mid - by["vv"][11.0]["per"])
    check(diff < 0.06, f"per: |Costas - V&V| = {diff:.4f} at 11 dB")
    for carrier, pts in by.items():  # every point within 3 sigma of theory
        for e, p in pts.items():
            q = qpsk_per_theory(e)
            sigma = np.sqrt(q * (1 - q) / n)
            check(sigma == 0 or abs(p["per"] - q) <= 3 * sigma,
                  f"per {carrier}: PER {p['per']:.4f} at {e} dB, theory {q:.4f} +- 3 x {sigma:.4f}")

    # the same samples on CPU tensors and on the card, fused acquisition
    # on both, so the kernels meet their plain versions
    cfg = dataclasses.replace(per_config("costas"), acquisition_backend="fused")
    x, payloads, power = per_signal("cpu", channels=10, seed=3)
    rng = np.random.default_rng(11)
    sigma = esn0_db_to_noise_sigma(11.0, power)
    x = x.numpy()
    noisy = (x + sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(np.complex64)
    rows = {}
    for where in ("cpu", dev):
        res = per_decode(Receiver(cfg, where), torch.from_numpy(noisy).to(where))
        rows[str(where)] = per_sets(res, payloads)[1]
    a, b = rows["cpu"], rows[str(dev)]
    differ = sum(len(set(ra) ^ set(rb)) for ra, rb in zip(a, b))
    check(differ <= 1, f"per: CPU and card decode {differ} packets differently at 11 dB")
    log(f"  per same samples, 240 packets at 11 dB: CPU {sum(map(len, a))}, card {sum(map(len, b))} decoded, "
        f"{differ} differing  [{card}]")
    return {"costas": curves["costas"], "vv": curves["vv"], "launches": launches,
            "same_samples": {"cpu": sum(map(len, a)), "card": sum(map(len, b)), "differing": differ}}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def keys(pkts) -> list[tuple]:
    return [(p.channel, p.index, p.data.tobytes(), p.arm) for p in pkts]


def multi_rank(rank: int, world: int, port: int, device_type: str, block: int, channels: int,
               units: int, out: str) -> None:
    """One rank of the multi-card run: a ``(ch, 2)`` mesh, and
    ``StreamingShardedBank`` (int8 wire) on the streaming stimulus; rank 0
    writes the packets' keys and every rank its launch counts to ``out``."""
    sys.path.insert(0, ROOT)
    import pickle

    import torch
    import torch.distributed as dist

    from gr4_packet_modem_tpu_torch.entry import BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.parallel.bank import make_mesh
    from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    mesh = make_mesh(world, time_shards=2, device_type=device_type)
    c_shards = world // 2
    bank = StreamingShardedBank(mesh, BENCH_CONFIG, channels=channels, block=block, group=16,
                                transfer_dtype=torch.int8,
                                result_budget=BENCH_CONFIG.max_detections * channels // c_shards)
    x_unit, _ = stream_stimulus(block, channels, units)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    pkts = []
    for _ in range(1 + units):
        pkts += bank.process(x_unit)
    pkts += bank.flush()
    dt = time.perf_counter() - t0
    with open(f"{out}.{rank}", "wb") as f:
        pickle.dump({"keys": keys(pkts) if rank == 0 else None, "launches": _build.launch_counts(),
                     "overflow": (bank.overflow_blocks, bank.budget_overflow_blocks),
                     "seconds": dt, "blocks": bank.stats["blocks"]}, f)
    dist.destroy_process_group()


def sharded_phase(torch, card: str, dev) -> dict:
    """On a 1 x 1 NCCL mesh: ``StreamingShardedBank`` beside
    ``StreamingBank`` (int8 wire, the streaming phase's stimulus), one
    ``ReceiverBank.step`` of the bench bank against ``bank_step(x, 16)``,
    and ``sharded_dryrun``; with two cards or more, also a ``(ch, 2)`` mesh
    of one process a card."""
    import pickle

    import torch.distributed as dist
    import torch.multiprocessing as mp

    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG, sharded_dryrun
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.parallel.bank import BankConfig, ReceiverBank, make_mesh
    from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank

    out = {}
    block, channels, units = BENCH_BLOCK, BENCH_CHANNELS, 3
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    mesh = make_mesh(1)
    log(f"  NCCL world 1, mesh {tuple(mesh.mesh.shape)} (ch, time)")

    # 1. the sharded driver beside StreamingBank, same stimulus, same
    # process, in turns: StreamingBank, sharded, sharded, StreamingBank
    x_unit, expected = stream_stimulus(block, channels, units)
    kw = dict(channels=channels, block=block, group=16, transfer_dtype=torch.int8,
              result_budget=BENCH_CONFIG.max_detections * channels)
    runs = []
    bank, sharded_bank = "StreamingBank int8", "StreamingShardedBank int8 1x1"
    for name in (bank, sharded_bank, sharded_bank, bank):
        sharded = name == sharded_bank
        driver = (StreamingShardedBank(mesh, BENCH_CONFIG, dev, **kw) if sharded
                  else StreamingBank(BENCH_CONFIG, dev, **kw))
        r, pkts = stream_run(torch, card, driver, x_unit, expected, units, name)
        del driver
        if sharded:
            for k in _build.KERNELS:
                check(r["launches"][k] > 0, f"kernel {k} was not launched by StreamingShardedBank")
            check(keys(pkts) == keys(ref_pkts), "StreamingShardedBank 1x1: packets differ from StreamingBank's")
        else:
            ref_pkts = pkts
        runs.append(dict(r, driver=name))
    rates = [f"{r['rate_sps']:.4e}" for r in runs]
    log(f"  StreamingShardedBank 1x1: the {len(ref_pkts)} packets of StreamingBank int8, in order; sustained "
        f"samples/s in turns (StreamingBank, sharded, sharded, StreamingBank): {', '.join(rates)}  [{card}]")
    out["streaming"] = runs

    # 2. one ReceiverBank step of the bench bank against bank_step(x, 16)
    rbank = ReceiverBank(mesh, BankConfig(rx=BENCH_CONFIG, channel_group=16))
    samples, want, _ = bench_signal(block, channels)
    x_loc = torch.from_numpy(samples).to(dev)
    res, launches = path_launches(torch, "ReceiverBank.step", lambda: rbank.step(x_loc), _build.KERNELS)
    rx = rbank.rx
    x = rx.pad(x_loc)
    ref_res = rx.bank_step(x, 16)[2]
    acc = ref_res.accepted.view(channels, -1)
    check(torch.equal(res.accepted, acc), "ReceiverBank: accepted rows differ from bank_step(x, 16)'s")
    check(torch.equal(res.lengths[acc], ref_res.lengths.view(channels, -1)[acc]), "ReceiverBank: lengths differ")
    check(torch.equal(res.data[acc], ref_res.data.view(channels, acc.shape[1], -1)[acc]), "ReceiverBank: bytes differ")
    check(int(acc.sum()) == channels * len(want), f"ReceiverBank: {int(acc.sum())} of {channels * len(want)} packets")
    # in turns, so that neither reads only the host's slow or fast moments
    fns = (lambda: rbank.step(x_loc).accepted.sum().item(),
           lambda: rx.bank_step(x, 16)[2].accepted.sum().item())
    times = ([], [])
    for r in range(6):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            times[i].append(median_ms(torch, fns[i], reps=1))
    step_ms, ref_ms = map(statistics.median, times)
    log(f"  ReceiverBank.step: {int(acc.sum())} packets, rows equal to bank_step(x, 16); {step_ms:.2f} ms "
        f"against {ref_ms:.2f} ms (medians of 6 in turns)  [{card}]")
    out["receiver_bank"] = {"launches": launches, "step_ms": step_ms, "bank_step_g16_ms": ref_ms,
                            "packets": int(acc.sum())}
    del rbank, rx, x, x_loc, res, ref_res

    # 3. the dry run
    dry, launches = path_launches(torch, "sharded_dryrun", lambda: sharded_dryrun(mesh, dev), _build.KERNELS)
    log(f"  sharded_dryrun: {dry}")
    out["dryrun"] = dict(dry, launches=launches)
    dist.destroy_process_group()

    # 4. one process a card, on a (ch, 2) mesh
    cards = torch.cuda.device_count()
    if cards >= 2:
        world = 4 if cards >= 4 else 2
        path = os.path.join(OUT_DIR, "multi_rank")
        os.makedirs(OUT_DIR, exist_ok=True)
        mp.spawn(multi_rank, args=(world, free_port(), "cuda", block, channels, units, path), nprocs=world)
        ranks = []
        for r in range(world):
            with open(f"{path}.{r}", "rb") as f:
                ranks.append(pickle.load(f))
        check(sorted(ranks[0]["keys"]) == sorted(keys(ref_pkts)),
              f"{world} ranks: packets differ from StreamingBank's")
        for r in ranks:
            check(r["overflow"] == (0, 0), f"{world} ranks: saturated blocks {r['overflow']}")
            check(all(r["launches"][k] > 0 for k in _build.KERNELS), f"{world} ranks: a kernel was not launched")
        log(f"  {world} cards, mesh ({world // 2}, 2): {len(ranks[0]['keys'])} packets, those of StreamingBank; "
            f"{ranks[0]['blocks']} blocks in {ranks[0]['seconds']:.2f} s  [{card}]")
        out["multi_card"] = {"world": world, "seconds": ranks[0]["seconds"]}
    else:
        log(f"  multi-card: {cards} card here; the multi-rank path ran only on the CPU (gloo: "
            "tests/test_torch_parallel.py, _serving.py, _multihost.py)")
    return out


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gr4_packet_modem_tpu_torch")):
        raise SystemExit("chip_smoke: gr4_packet_modem_tpu_torch/ is missing: run it from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    tf32_defaults = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

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

    # phases 6-8: the symbol taps, the transmitter, the transceiver
    log("taps:")
    dev = torch.device("cuda")
    tapres = taps_phase(torch, card, dev)
    log("tx:")
    txres = tx_phase(torch, card, dev, tf32_defaults)
    log("transceiver:")
    trxres = transceiver_phase(torch, card, dev)

    # phases 9-10: the PER curve, the sharded receiver and serving driver
    log("per:")
    perres = per_phase(torch, card, dev)
    log("sharded:")
    shres = sharded_phase(torch, card, dev)
    import gr4_packet_modem_tpu_torch.io.zmq_pub  # noqa: F401  (the taps' publisher, no pyzmq here)

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
                   "streaming": stres, "taps": tapres, "tx": txres, "transceiver": trxres,
                   "per": perres, "sharded": shres,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
