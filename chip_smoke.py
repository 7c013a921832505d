#!/usr/bin/env python3
"""Drive the PyTorch port's receive and transmit paths once on one NVIDIA
GPU.

Phases, in order; any failure raises and the script exits non-zero:

1. device: require CUDA, print the card's name and power limit;
2. build: compile the CUDA kernels (``gr4_packet_modem_tpu_torch/csrc``)
   with nvcc, one process per source, into ``build/kernels/``, and beside
   them, in parallel, the probe ``csrc/probe/chain.cu`` (chain latency and
   an empty kernel);
3. kernels: hold each kernel against its plain PyTorch version on the card
   at the receive chain's shapes (K2, K2b, K4, K5 and the payload CRC
   kernel bit for bit; the CRC kernel at the dense cells' and the mixed
   cell's shapes, its bound the bytes of each row's own symbols); time the
   kernel, its plain version and, where one PyTorch call computes the same
   function, that call (``library_ms``: ``unfold`` and index for K2, on the
   complex bank, and K2b, the depthwise strided ``conv1d`` with TF32 off
   for K3), each as device time from torch.profiler over a loop of calls
   with the L2 evicted before each, with the host's time per call beside it
   where that is larger; K1 and K3 in turns with their yardstick; each
   kernel's bound (``bound_ms``: bytes over 3.35 TB/s or float32
   operations over 67 TFLOP/s, whichever is larger) and, beside every row,
   the launch floor (``launch_floor_ms``: an empty kernel timed the same
   way). K2b is also timed with the L2 warm, as the main path finds its
   inputs. The recursions
   K4 and K5 are also timed at B=32 (one warp) and given a chain floor: the
   cycles of their step bodies run by one warp on registers, over the SM
   clock that ``nvidia-smi`` reads. K4 with slots that hold no detection
   (``costas_mask_rows``), at the dense and mixed cells' payload and
   header shapes: the locked loop's symbols, the same with the empty
   slots' rows scaled by 1e9 (as the receiver hands them over) unmasked,
   and those rows masked off, the masked call bit-identical to the masked
   plain route and, on its active rows, to the clean call, and
   ``skipped_rows`` grown by the masked rows; all three timed. The fused extraction
   (``pm_extract_symbols``) at the header pass's, the dense cells' payload
   and the mixed cell's payload shapes (nine chunks) on a random bank laid
   out as a bank step lays its rows, within K3's tolerance of the plain
   chain and bit-identical to the unfused chain of kernels it replaced
   (K2, the derotation in PyTorch, K3's plane entry), timed beside both;
   its bound the union of the bank samples its rows need (rows of a
   channel overlap), the taps, the rows' parameters and the output
   (``extraction_least_bytes``). The ``kernels`` line gives each launch
   key's main-path shape: K2 at acquisition's noise window (R=1569), K3
   (``matched``) the fused extraction at the mixed payload; K3's plane
   entry is timed beside it (``matched_plane`` rows);
4. slice: ``Receiver.bank_step`` at the bench geometry (64 channels of
   2**19 samples of back-to-back 1500-byte bursts, 9 frequency bins,
   1536-byte max payload, 24 detection slots, V&V payload carrier, fused
   acquisition) as one batch (``group=0``); every packet fully inside the
   block must decode byte-exact, and every kernel must have been launched
   by that run; its peak device memory is printed (the benchmark and
   ``scripts/trace_rx_torch.py`` time the step). Every such bank step is
   run twice more, captured into CUDA graphs and then replayed from them:
   the replay is counted and gives the first step's rows. The same step
   in channel groups of 16 (``bank_step``'s default)
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
   ``StreamingBank``'s packets;
11. apps: the block registry (every entry resolves; ``HeaderLdpcDecoder``
   at B=1536 bit for bit against the CPU, one K5 launch; the CRC blocks,
   the slicer, the soft descrambler, the symbol filter and the V&V
   estimate against the CPU), then the apps through their ``run()``: the
   TX app to a file and the file RX app back (100 x 1500 B, burst and
   stream, byte-exact at their sample indices), the transceiver app's
   self-test loopback (burst with CFO 0.005 and SFO 1.2 ppm, stream with
   CFO 0.005, each 3 s unthrottled and 3 s at 3.2 Msps; every packet back
   byte-exact, all seven kernels launched) with its rates and loop split,
   the loop's TX and channel timed apart, and the throttle app at 3.2 Msps. No TUN device is opened
   (``TunDevice`` needs CAP_NET_ADMIN; the CPU tests hold the native
   library);
12. examples: every example of ``gr4_packet_modem_tpu_torch/examples/``
   through its ``run(["--device", "cuda"])`` (``tun_loopback`` in demo
   mode), the three mesh examples on one spawned NCCL rank (a 1 x 1 mesh),
   each held to its own checks and to its outcome (byte-exact payloads at
   their indices, the PER curve's ends, the header examples' bits and
   flags equal to their CPU runs'); K1 and K2b launched by
   ``syncword_detection``, K5 by the header examples, all seven by every
   other receiving example. One line an example: its wall time, outcome
   and launches;
13. benchmarks: every measurement program of the port
   (``gr4_packet_modem_tpu_torch.bench`` and ``.benchmarks.benchmark_*``)
   through its ``run(device="cuda")`` at its own defaults: ``bench`` (64 x
   2**19, group 16, 20 iterations, int8 wire, an 8-channel bank, the
   sharded bank on an NCCL world of one it starts) with
   ``decoded_packet_frac`` 1.0 and its three parity gates holding at
   non-zero rates; the receiver program (4 bins, 8 channels, 2**18) with
   ``decoded_frac`` 1.0; syncword detection at 4 bins and 2**18 with fft
   (K2, K2b) and fused (K1 too) acquisition and no decode kernel; the
   transceiver program at 24/24; the TX program in burst and stream mode
   (64 packets), one call's samples within 1e-5 of the CPU's; bank scaling
   (8 channels a card, 2**17) at one card, efficiency 1. All seven kernels
   launched by each receiving program; each program's JSON line printed;
14. envelope: the u16 payload envelope of tests/test_large_payload.py
   (16,384 + 5,000 bytes at 4 bins, 65,535 bytes at 1 bin) with both
   payload carriers through the port's transmitter on the card, ``rotate``,
   numpy noise and ``Receiver.receive``: every payload byte-exact, all seven
   kernels launched, the fused extraction once a pass (the payload's 33 or
   129 chunks in one launch) and K2 once (acquisition); the receive
   time (median of 3), its peak device memory and each kernel's device time
   in the acquisition and the payload pass; the V&V cases and 16 KiB Costas
   equal to the port's CPU run on the same samples. K4 at [2, 262,156]
   bit for bit against two launches chained through its loop state and,
   on its first 4,096 symbols, against the plain loop, timed beside its
   chain floor; K4 the same at u16_16k's [4, 65,552] (the first 4,096
   symbols, its time, chain floor and plain time); the 65,535-byte TX
   within 1e-5 of the CPU; the symbol
   timing sweep of tests/test_symbol_timing.py (nine delays across +-0.5
   sample, and -0.45 with a CFO of 0.006) held to the JAX test's bounds;
15. backends: the acquisition backends ``fused_bf16``, ``conv`` and
   ``conv_bf16``. K1's bf16 form (``csrc/correlate_bf16.cu``) against its
   plain version at the bench shape (every best power within 2e-2 of
   itself plus 1e-4 of the largest; every best bin equal where the plain
   version's best bin leads its second by more than 5 % and by more than
   2e-4 of the largest), timed in turns with the float32 K1, with its
   bound's three terms (bytes, float32 operations, bf16 tensor-core
   operations at 989 TFLOP/s), its registers, spills, shared memory,
   resident blocks and frames in flight an SM at each size, and the HGMMA
   instructions in its SASS (``cuobjdump``; each of its three kernels must
   hold some). At N=4096 and 8192 on the bench bank as a Receiver with
   that ``acquisition_fft_size`` pads it (10,240 and 5,120 frames): the
   streaming kernel under the same gate, then timed in turns with the
   float32 K1, each with its plain version and bound. ``bank_step`` of
   the bench bank at group 0 with each of the three backends, every packet
   byte-exact and the fused backend's detections, ``correlate_bf16``
   launched on the ``fused_bf16`` path and neither K1 on the conv paths
   (each step also replayed from graphs, as in phase 4);
   the bench bank at ``acquisition_fft_size`` 4096 and 8192 with fused and
   fused_bf16, every packet byte-exact, the two with equal detections
   inside the capture (past its end, in the zero padding, each form
   detects its own rounding error and none decodes: counted; where the bf16
   form's such events outnumber a channel's free slots its overflow flag
   is counted, not failed on), the
   peak memory, and the one K1 form launched; ``bench`` at
   the JAX records' ``default_vv_bf16`` and ``ch64_g16_bf16``
   configurations (``decoded_packet_frac`` 1.0, the gates holding); the
   syncword program at 4 bins with all five backends.

Each path runs with the launch counts set to 0 just before it and read
just after; each path of the receiver with fused acquisition must have
launched the seven kernels of ``ALL_KERNELS``, and each ``fused_bf16`` path
``correlate_bf16`` in K1's place.

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
    "correlate_bf16": ("gr4_packet_modem_tpu_torch/csrc/correlate_bf16.cu",
                       "gr4_packet_modem_tpu/ops/acquire_pallas.py:375"),
    "crc": ("gr4_packet_modem_tpu_torch/csrc/crc.cu",
            "none (the JAX package's CRC check is plain JAX, gr4_packet_modem_tpu/ops/crc.py::CrcEngine)"),
}
# the kernels a receive with fused acquisition launches (phases 4-14); K1's
# bf16 form, correlate_bf16, runs on phase 15's fused_bf16 paths
ALL_KERNELS = ("fetch", "fetch_rows", "matched", "costas", "ldpc", "correlate", "crc")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet, dense, 700 W)
PEAK_BYTES_PER_S = 3.35e12  # HBM3
PEAK_F32_PER_S = 67e12  # float32 outside the tensor cores
PEAK_BF16_TC_PER_S = 989e12  # bf16 on the tensor cores


def bound_terms(nbytes: float, ops: float, tc_ops: float = 0.0) -> dict:
    """ms of each of ``bound``'s terms: ``bytes``, ``f32`` and ``bf16_tc``."""
    return {"bytes": nbytes / PEAK_BYTES_PER_S * 1e3, "f32": ops / PEAK_F32_PER_S * 1e3,
            "bf16_tc": tc_ops / PEAK_BF16_TC_PER_S * 1e3}


def bound(nbytes: float, ops: float, tc_ops: float = 0.0) -> tuple[float, str]:
    """(least ms the card could take, "bytes" or "operations"): the largest
    of ``nbytes`` over the memory rate, ``ops`` (float32) over the float32
    rate and ``tc_ops`` (bf16 tensor-core operations) over the bf16
    tensor-core rate."""
    t = bound_terms(nbytes, ops, tc_ops)
    tb, to = t["bytes"], max(t["f32"], t["bf16_tc"])
    return (tb, "bytes") if tb >= to else (to, "operations")


def k1_work(fpad: int, s: int, n: int, nb: int) -> tuple[float, float]:
    """(bytes, float32 operations) of the float32 K1 on ``fpad`` frames: the
    frame views read once (2 planes, FPAD + 1 rows), the replica table
    once, both outputs written once; a frame's one forward and nb inverse
    transforms at the split-radix count, 4 N log2 N - 6 N + 8 real
    operations each, then product, power and max, 10 operations a point and
    bin."""
    return (2 * (fpad + 1) * s * 4 + nb * n * 8 + fpad * n * 8,
            fpad * ((1 + nb) * (4 * n * np.log2(n) - 6 * n + 8) + nb * n * 10))


# the fused extraction's timed shapes: rows, symbols, chunk, first symbol,
# channels, samples a channel (the header pass and the dense cells' payload
# pass on 64 x 553,396 samples, the mixed cell's payload pass on 64 x 594,356)
EXTRACT_SHAPES = {
    "header": (1536, 192, 192, 0, 64, 553_396),
    "dense_payload": (1536, 6160, 6160, 192, 64, 553_396),
    "mixed_payload": (3584, 16400, 2048, 192, 64, 594_356),
}


def extract_inputs(torch, gen, d: int, s: int, chunk: int, off: int, chans: int, row_len: int) -> tuple:
    """``extract_symbols``' arguments for ``d`` rows on a random bank, as a
    bank step lays them: the rows channel-major, each channel's starts
    sorted and spread over its row (so that neighbouring slots overlap in
    the bank, as packets back to back do), of both parities; the last
    row's starts near its row's end (its later chunks clamped); CFOs to
    0.03 rad/sample, random arm taps and amplitude scales."""
    dev = torch.device("cuda")
    x = torch.randn(chans * row_len, generator=gen, device=dev, dtype=torch.complex64)
    per = d // chans
    chan = torch.arange(chans, device=dev).repeat_interleave(per)
    span = 4 * (off + s)
    n_base = torch.randint(0, row_len - span, (chans, per), generator=gen, device=dev).sort(dim=1).values
    n_base = n_base.reshape(-1)
    n_base[-1] = row_len - 700
    arm_taps = 0.3 * torch.randn(32, 44, generator=gen, device=dev)
    arm = torch.randint(0, 32, (d,), generator=gen, device=dev)
    freq = 0.06 * torch.rand(d, generator=gen, device=dev) - 0.03
    n0 = n_base - torch.randint(0, 60, (d,), generator=gen, device=dev)
    amp = 0.5 + 1.5 * torch.rand(d, generator=gen, device=dev)
    return x, row_len, n_base, chan, arm, arm_taps, freq, n0, amp, 4, off, s, chunk


def extraction_least_bytes(n_base, chan, row_len: int, kk: int, sps: int, off: int, s: int,
                           chunk: int, arms: int) -> int:
    """The least bytes a fused extraction of ``s`` symbols from symbol
    ``off`` of each row moves: the union over rows and chunks of the bank
    samples the written symbols need (each chunk's start clamped as the
    kernel clamps it; the rows of a channel overlap, as packets back to
    back do, and a sample is read once), the ``[arms, kk]`` tap table,
    each row's six parameters (40 bytes) and the ``[D, s]`` complex64
    output written once. ``n_base`` and ``chan`` (None: one capture) are
    numpy arrays."""
    n_base = np.asarray(n_base, np.int64)
    at = 0 if chan is None else np.asarray(chan, np.int64) * row_len
    r = sps * (chunk - 1) + kk
    first, end = [], []
    for c in range(-(-s // chunk)):
        st = at + np.clip(n_base + sps * (off + c * chunk) - (kk - 1), 0, row_len - r)
        first.append(st)
        end.append(st + sps * (min(chunk, s - c * chunk) - 1) + kk)
    first, end = np.concatenate(first), np.concatenate(end)
    order = np.argsort(first, kind="stable")
    first, reach = first[order], np.maximum.accumulate(end[order])
    runs = np.flatnonzero(np.r_[True, first[1:] > reach[:-1]])  # where a run of overlapping spans starts
    samples = int((reach[np.r_[runs[1:] - 1, first.size - 1]] - first[runs]).sum())
    d = n_base.shape[0]
    return samples * 8 + arms * kk * 4 + d * 40 + d * s * 8


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
    leave it. The profiler now and then drops records, or a whole session's
    (see ``timed``): up to four sessions run until one keeps a whole number
    of calls' records; failing that, the session that kept the most counts,
    and where none kept any, both numbers are NaN (not measured)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    best = []
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type == cuda]
        if len(events) > len(best):
            best = events
        if events and len(events) % reps == 0:
            break
    else:
        if not best:
            log("  (profiler: no record in four sessions; busy not measured)")
            return float("nan"), float("nan")
        log(f"  (profiler: no session of four kept whole calls; busy from the fullest, {len(best)} records)")
    return sum(e.time_range.elapsed_us() for e in best) / 1e3 / reps, len(best) / reps


def timed(torch, fn, reps: int = 10, flush: bool = True) -> dict:
    """Per call of ``fn``: ``ms``, the device time with the L2 cold
    (torch.profiler: the time of every kernel the call launches, summed
    over ``reps`` calls, each after a write of ``FLUSH_BYTES`` whose own
    kernel is left out, divided by ``reps``, after a warm-up; with
    ``flush`` False the write is left out too, so each call finds in the
    L2 what the call before left there; where every session dropped
    records, ``pooled_call_ms`` of them; where they kept too few for that,
    ``loop_ms``, which for a small kernel is the host's time to issue one);
    ``loop_ms``, CUDA events around ``reps`` back-to-back calls; ``host_ms``,
    the host's time to issue one call in that loop; ``timer``, "profiler"
    or "events", which of the two ``ms`` is."""
    from torch.profiler import ProfilerActivity, profile

    if not _flush:
        _flush.append(torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device="cuda"))
    scratch = _flush[0]
    loop, host = loop_ms(torch, fn, reps)
    cuda = torch.autograd.DeviceType.CUDA
    # a profiler session now and then drops kernel records (seen on the
    # card: a first flush; once a flush in four and a call's kernel in ten,
    # three sessions running), so each opens with a flush of its own and
    # counts only if each call's kernels came in whole (their number a
    # multiple of reps)
    sessions = []
    for _ in range(4):
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
            busy = sum(e.time_range.elapsed_us() for e in calls)
            return {"ms": busy / 1e3 / reps, "loop_ms": loop, "host_ms": host, "timer": "profiler"}
        sessions.append(calls)
    ms = pooled_call_ms(sessions, reps)
    if ms is None:
        log(f"  (profiler kept fewer than half of each kernel's {reps} calls in {len(sessions)} sessions, "
            f"{sum(map(len, sessions))} records: CUDA events around {reps} calls instead)")
        return {"ms": loop, "loop_ms": loop, "host_ms": host, "timer": "events"}
    return {"ms": ms, "loop_ms": loop, "host_ms": host, "timer": "profiler"}


def mean_timed(a: dict, b: dict) -> dict:
    """The mean of two ``timed`` results of one call, key by key; ``timer``
    names both where they differ."""
    timer = a["timer"] if a["timer"] == b["timer"] else f"{a['timer']}+{b['timer']}"
    return {**{key: (a[key] + b[key]) / 2 for key in a if key != "timer"}, "timer": timer}


def pooled_call_ms(sessions: list, reps: int) -> float | None:
    """A call's device ms from profiler sessions of ``reps`` calls each of
    which dropped records: for each kernel name, the mean time of its
    records in all sessions times its launches a call (the most records a
    session kept of it over ``reps``, rounded), summed over names; None
    where no session kept half of any kernel's calls."""
    durations, most = {}, {}
    for calls in sessions:
        seen = {}
        for e in calls:
            durations.setdefault(e.name, []).append(e.time_range.elapsed_us())
            seen[e.name] = seen.get(e.name, 0) + 1
        for name, n in seen.items():
            most[name] = max(most.get(name, 0), n)
    per_call = {name: round(n / reps) for name, n in most.items()}
    if not any(per_call.values()):
        return None
    log(f"  (profiler: every session dropped records; {', '.join(f'{k} x{v}' for k, v in per_call.items())}"
        f" a call, each at the mean of {sum(map(len, sessions))} records)")
    return sum(statistics.fmean(durations[name]) * k for name, k in per_call.items()) / 1e3


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


def build_chain_probe():
    """Build and load the probe ``csrc/probe/chain.cu`` (chain floors and
    the empty kernel of the launch floor), with its entry points' argument
    types."""
    import ctypes

    from gr4_packet_modem_tpu_torch.ops import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib = _build.build_single(_build.CSRC / "probe" / "chain.cu")
    # cycles, sink, steps, offset, stream
    lib.pm_costas_chain.argtypes = [P, P, I, I, P]
    # cycles, sink, llrs, chk_vars, var_edges, m, dmax, n, vdeg, iters, alpha, stream
    lib.pm_ldpc_chain.argtypes = [P, P, P, P, P, I, I, I, I, I, F, P]
    lib.pm_empty.argtypes = [P]
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


def crc_inputs(torch, dev, gen, d: int, max_len: int, pool, share: float):
    """The payload CRC check's inputs at ``d`` rows of ``max_len``: random
    symbols, the receiver's LLR scale and packed keystream, lengths drawn
    from ``pool`` in a ``share`` of the rows and garbage (0 to 65,535)
    in the rest, and the CRC engine's tables. Returns ``(payload_crc's
    arguments, lengths as numpy)``."""
    from gr4_packet_modem_tpu_torch.models.tables import tables_from_numpy
    from gr4_packet_modem_tpu_torch.ops.crc import crc32_tables
    from gr4_packet_modem_tpu_torch.ops.scramble import keystream_np
    from gr4_packet_modem_tpu_torch.utils import constants as C

    s_pay = 4 * (max_len + 4)
    ks = np.packbits(keystream_np(C.HEADER_LLRS + 2 * s_pay)[C.HEADER_LLRS:])
    t = tables_from_numpy(crc32_tables(max_len))
    rng = np.random.default_rng(d + max_len)
    lens = rng.choice(np.asarray(pool, np.int64), d)
    garbage = rng.random(d) >= share
    lens[garbage] = rng.integers(0, 65_536, int(garbage.sum()))
    sym = torch.randn(d, s_pay, generator=gen, device=dev, dtype=torch.complex64)
    scale = torch.tensor(np.float32(2.0 / C.LLR_NOISE_SIGMA**2), device=dev)
    tables = tuple(t[k].to(dev) for k in ("g_packed", "init_lut", "final_xor"))
    return (sym, scale, torch.from_numpy(ks).to(dev), torch.from_numpy(lens).to(dev), *tables), lens


# K4's masked rows: (label, B, S, offset, inactive(row)) at the cells'
# shapes: the dense cells' 24 slots a channel with 2 empty, the mixed
# cell's 56 with the last 17 empty (its ~17 without a packet)
COSTAS_MASKS = (
    ("dense payload", 1536, 6160, 192, lambda i: i % 24 >= 22),
    ("mixed payload", 3584, 16400, 192, lambda i: i % 56 >= 39),
    ("dense header", 1536, 192, 0, lambda i: i % 24 >= 22),
    ("mixed header", 3584, 192, 0, lambda i: i % 56 >= 39),
)


def costas_mask_rows(torch, card: str) -> list:
    """K4 with slots that hold no detection, at the cells' shapes: the
    locked loop's symbols (``clean``); the same with the empty slots' rows
    scaled by 1e9 as the receiver hands them over, unmasked (``scaled``:
    their loops run away into cosf's slow reduction); and those rows
    masked off (``masked``: the receiver's call). The masked call's active
    rows bit-identical to the clean call's, its inactive rows zeros with
    their state as it came, and all of it bit-identical to the plain route
    with the same mask; ``skipped_rows`` grown by the inactive rows. Each
    timed as ``timed`` times the kernels, the L2 evicted before each call."""
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain, skipped_rows
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols

    dev = torch.device("cuda")
    rows = []
    for label, b, s, offset, inactive in COSTAS_MASKS:
        sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(b, s, offset, seed=11 + s))
        active = torch.from_numpy(np.array([not inactive(i) for i in range(b)])).to(dev)
        scaled = torch.where(active[:, None], sym, sym * 1e9)
        idle = int((~active).sum())
        clean = costas_track(sym, ph0, fr0, offset=offset)
        before = skipped_rows(dev)
        masked = costas_track(scaled, ph0, fr0, offset=offset, active=active)
        check(skipped_rows(dev) - before == idle, f"costas {label}: skipped_rows did not grow by {idle}")
        check(all(torch.equal(m[active], c[active]) for m, c in zip(masked, clean)),
              f"costas {label}: the masked call's active rows differ from the clean call's")
        check(not bool(masked[0][~active].any()) and torch.equal(masked[1][~active], ph0[~active])
              and torch.equal(masked[2][~active], fr0[~active]),
              f"costas {label}: inactive rows not zeros with their state as it came")
        plain = costas_track_plain(scaled, ph0, fr0, offset, active)
        check(all(torch.equal(m, p) for m, p in zip(masked, plain)),
              f"costas {label}: masked kernel not bit-identical to the masked plain route")
        del plain
        times = {
            "clean": timed(torch, lambda: costas_track(sym, ph0, fr0, offset=offset)),
            "scaled": timed(torch, lambda: costas_track(scaled, ph0, fr0, offset=offset)),
            "masked": timed(torch, lambda: costas_track(scaled, ph0, fr0, offset=offset, active=active)),
        }
        bms, by = bound(2 * b * s * 8 + 4 * b * 4, b * s * (15 + 40))
        ms = {k: t["ms"] for k, t in times.items()}
        shape = f"B={b} S={s} offset={offset}, {idle} rows 1e9-scaled"
        log(f"  costas {label} {shape}: clean {ms['clean']:.4f} ms, scaled unmasked {ms['scaled']:.4f} ms "
            f"({ms['scaled'] / ms['clean']:.2f} x), masked {ms['masked']:.4f} ms "
            f"({ms['masked'] / ms['clean']:.3f} x clean); masked bit-identical to the plain route and, on "
            f"its active rows, to clean; bound {bms:.4f} ms ({by}, {100 * bms / ms['masked']:.2f} % of "
            f"masked)  [{card}]")
        rows.append({"name": "costas_masked", "label": label, "shape": shape, "inactive_rows": idle,
                     "bound_ms": bms, "bound_by": by, **{f"{k}_ms": v for k, v in ms.items()},
                     **{f"{k}_timer": t["timer"] for k, t in times.items()}})
        del sym, scaled, clean, masked
    return rows


def kernel_checks(torch, card: str, chain) -> dict:
    """Each kernel against its plain version at the chain's shapes; the
    time of each, of its plain version and, where one PyTorch call computes
    the same function, of that call; each kernel's bound at its shape and
    the launch floor. K4 and K5 also at B=32 and with their chain floors
    (``chain``: the library of ``build_chain_probe``). Launches here are
    comparisons: they do not count as the main path's."""
    # the yardstick convolution in full float32, as the kernel computes;
    # the flag is restored for the later phases
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _kernel_checks(torch, card, chain)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _kernel_checks(torch, card: str, chain) -> dict:
    import torch.nn.functional as F

    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver
    from gr4_packet_modem_tpu_torch.ops import _build, ldpc
    from gr4_packet_modem_tpu_torch.ops.acquire import AcquisitionConfig, SyncwordAcquirer
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power, fused_best_power_plain
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain
    from gr4_packet_modem_tpu_torch.ops.crc import payload_crc, payload_crc_plain
    from gr4_packet_modem_tpu_torch.ops.fetch_cuda import (
        fetch_regions, fetch_regions_plain, fetch_rows, fetch_rows_plain,
    )
    from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals
    from gr4_packet_modem_tpu_torch.ops.matched_cuda import (
        extract_symbols, extract_symbols_plain, matched_filter, matched_filter_plain,
    )
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols, ldpc_encode_bytes

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    d = 1536  # 64 channels x 24 detection slots
    res, rows = {}, []

    def stream():
        return torch.cuda.current_stream().cuda_stream

    # the launch floor: an empty kernel (one warp), timed as the kernels are
    def empty():
        check(chain.pm_empty(stream()) == 0, "pm_empty: launch failed")

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
    # both parities and both edge starts; R=1569 is acquisition's noise
    # window, the main path's one K2 launch a step, R=808 and 24,680 the
    # header's and the dense payload's regions of the unfused chain
    t = 64 * 553_396
    x = torch.randn(t, generator=gen, device=dev, dtype=torch.complex64)
    for r in (1569, 808, 24_680):
        starts = torch.randint(0, t - r + 1, (d,), generator=gen, device=dev)
        starts[:3] = torch.tensor([0, 1, t - r])
        kr, ki = fetch_regions(x, starts, r)
        torch.cuda.synchronize()
        pr, pi = fetch_regions_plain(x, starts, r)
        check(torch.equal(kr, pr) and torch.equal(ki, pi), f"fetch R={r}: not bit-exact")
        del kr, ki, pr, pi
        k = timed(torch, lambda: fetch_regions(x, starts, r))
        pms = timed(torch, lambda: fetch_regions_plain(x, starts, r))["ms"]
        lib = timed(torch, lambda: torch.view_as_real(x).unfold(0, r, 1)[starts])["ms"]
        record("fetch", f"D={d} R={r}", 0.0, k, pms, lib, 2 * (2 * d * r * 4) + d * 8, 0,
               r == 1569)
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
        k = mean_timed(k1, k2)
        fpad, nb = ar.shape[0], a.num_bins
        nbytes, ops = k1_work(fpad, s, n, nb)
        record("correlate", f"C={c} FPAD={fpad} S={s} {label} nb={nb}", err, k, (p1 + p2) / 2,
               None, nbytes, ops, label == "N=2048")
        del x, ar, ai, br, bi, args

    # K3's plane entry (matched_filter, the unfused chain's filter and no
    # longer on the main path): header (S=192) and payload (S=6160) regions;
    # the kernel and the depthwise strided conv1d in turns
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
        k = mean_timed(k1, k2)
        pms = timed(torch, lambda: matched_filter_plain(zr, zi, taps, sps, s), reps=3)["ms"]
        record("matched_plane", f"D={d} S={s} R={r}", err, k, pms, (l1 + l2) / 2,
               2 * d * r * 4 + d * kt * 4 + 2 * d * s * 4, 2 * 2 * d * s * kt, False)
        del zr, zi

    # the fused extraction (csrc/matched.cu, pm_extract_symbols; launch
    # key matched, the main path's K3) at the cells' shapes, on a random
    # bank laid out as a bank step lays its rows: within K3's tolerance of
    # the plain chain (K2's, the derotation's and K3's plain passes), bit
    # for bit the unfused chain of kernels it replaced (K2, the derotation
    # in PyTorch, K3's plane entry), timed beside both; bound: the union of
    # the samples its rows need (extraction_least_bytes). The mixed
    # payload's row is the kernel's main record.
    for label, (dd, s, chunk, off, chans, row_len) in EXTRACT_SHAPES.items():
        args = extract_inputs(torch, gen, dd, s, chunk, off, chans, row_len)

        def unfused():
            return extract_symbols_plain(*args, fetch=fetch_regions, filt=matched_filter)

        got = extract_symbols(*args)
        torch.cuda.synchronize()
        want = extract_symbols_plain(*args)
        check(torch.allclose(got, want, rtol=1e-5, atol=1e-4), f"extract {label}: beyond rtol 1e-5 atol 1e-4")
        check(torch.equal(got, unfused()), f"extract {label}: not bit-identical to the unfused chain")
        err = (got - want).abs().max().item()
        del got, want
        k = timed(torch, lambda: extract_symbols(*args))
        pms = timed(torch, lambda: extract_symbols_plain(*args), reps=3)["ms"]
        ums = timed(torch, unfused, reps=3)["ms"]
        samples = -(-s // chunk) * (4 * (chunk - 1) + kt)
        nbytes = extraction_least_bytes(args[2].cpu().numpy(), args[3].cpu().numpy(), row_len, kt, 4,
                                        off, s, chunk, args[5].shape[0])
        record("matched", f"extract {label} D={dd} S={s} chunk={chunk}", err, k, pms, None,
               nbytes, dd * (samples * 48 + s * 4 * kt), label == "mixed_payload",
               {"unfused_ms": ums, "unfused_bit_identical": True})
        del args

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
                          chain_floor(torch, chain, "pm_costas_chain", s, offset))
        # a symbol: derotation 6, error 2, loop update 5, wraps 2, and the
        # accurate cosf and sinf counted as 20 operations each
        record("costas", shape, err, k, pms, None,
               2 * d * s * 8 + 4 * d * 4, d * s * (15 + 40), s == 192, extra)
        del sym, ko, po
    rows.extend(costas_mask_rows(torch, card))

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
    floor = chain_floor(torch, chain, "pm_ldpc_chain", llr.data_ptr(), cv.data_ptr(),
                        ve.data_ptr(), m, dmax, n, vdeg, iters, alpha)
    extra = recursion("ldpc", shape, k, lambda: ldpc_totals(llr[:32], cv, ve), floor)
    # an edge an iteration: the variable sum's add; the check's subtract,
    # sign, magnitude, two minima and the scaled message's two products
    record("ldpc", shape, err, k, pms, None,
           2 * d * 128 * 4, d * iters * edges * 8, True, extra)

    # the payload CRC kernel (no TPU kernel) against its plain version, the
    # chain it replaced: the dense cells' [1536, 6160] symbols at 1536-byte
    # slots (22 of 24 slots a 1500-byte packet) and the mixed cell's
    # [3584, 16400] at 4096 (upstream's 15 lengths in 2,450 of 3,584 slots);
    # the other slots garbage header lengths up to 65,535, so whole rows
    for dd, max_len, pool, share in ((d, 1536, (1500,), 22 / 24),
                                     (3584, 4096, (*LOOPBACK_LENGTHS, 4096), 2450 / 3584)):
        args, lens = crc_inputs(torch, dev, gen, dd, max_len, pool, share)
        kout = payload_crc(*args)
        torch.cuda.synchronize()
        pout = payload_crc_plain(*args)
        check(all(torch.equal(a, b) for a, b in zip(kout, pout)),
              f"crc max_len={max_len}: payload or CRC words not bit-identical to the plain version")
        del kout, pout
        k = timed(torch, lambda: payload_crc(*args))
        pms = timed(torch, lambda: payload_crc_plain(*args), reps=3)["ms"]
        # the symbols of each row's own bytes and its CRC's, the lengths,
        # keystream and tables read once; the payload and both words written
        n = np.clip(lens, 0, max_len)
        nbytes = (32 * int((n + 4).sum()) + dd * 8 + (max_len + 4) + 4 * (256 + 32 * 13)
                  + 8 * (max_len + 2) + dd * max_len + 2 * dd * 8)
        record("crc", f"D={dd} S={4 * (max_len + 4)} max_len={max_len}", 0.0, k, pms, None,
               nbytes, 0, max_len == 1536, {"symbol_bytes": 32 * int((n + 4).sum())})
        del args
    _flush.clear()  # so the bank step's peak device memory leaves it out
    res["rows"] = rows
    return res


# ------------------------------------------------------------------ slice


def bank_run(torch, card: str, rx, x, expected, label: str, group: int = 0, overflow_ok: bool = False):
    """One ``bank_step(x, group)`` with the launch counts set to 0 just
    before it and read just after; the decode gate (no channel's
    detections overflowing its slots, unless ``overflow_ok``: then the
    overflowing channels are counted, and the caller holds the detections
    that matter); its peak device memory; then two more steps, the last
    replayed from CUDA graphs and held to the first. Returns the numbers
    and the first step's ``(det, res, keep)``."""
    from gr4_packet_modem_tpu_torch.ops import _build

    channels = x.shape[0]
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    det, hdr, res, keep = rx.bank_step(x, group)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"  {label}: launches in one bank_step: {launches}")

    overflowed = int(det.overflow.sum())
    check(overflow_ok or not overflowed, f"{label}: detections overflowed the slots")
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
    if overflowed:
        log(f"  {label}: {overflowed} channel(s) with more detection events than slots")

    # the same step again, captured into CUDA graphs, then replayed from
    # them: the replay counted, and its rows the eager step's
    rx.bank_step(x, group)
    replayed = rx.graph_counts()["replayed"]
    rdet, _, rres, rkeep = rx.bank_step(x, group)
    check(rx.graph_counts()["replayed"] == replayed + 1, f"{label}: the third step was not replayed")
    same_rows(torch, (rdet, rres, rkeep), (det, res, keep), f"{label} replayed against eager")
    return {"launches": launches, "group": group, "peak_bytes": peak, "packets": int(acc.sum()),
            "overflowed": overflowed}, (det, res, keep)


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
    for k in ALL_KERNELS:
        check(fused["launches"][k] > 0, f"kernel {k} was not launched by the main path")
    # channel groups of 16 (bank_step's default): four groups, one after another
    fused16, rows16 = bank_run(torch, card, rx, x, expected, "fused group 16", group=16)
    for k in ALL_KERNELS:
        check(fused16["launches"][k] > 0, f"kernel {k} was not launched by the group-16 step")
    same_rows(torch, rows16, fused_rows, "fused group 16 against group 0")
    del rows16

    # the fft backend as the second path, on the same bank
    rx_fft = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_backend="fft"), dev)
    fft, fft_rows = bank_run(torch, card, rx_fft, x, expected, "fft")
    check(fft["launches"]["correlate"] == 0, "the fft path launched the fused correlator")
    for k in ALL_KERNELS:
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
    for k in ALL_KERNELS:
        check(costas["launches"][k] > 0, f"kernel {k} was not launched by the Costas carrier's step")
    costas16, rows16 = bank_run(torch, card, rx_costas, x, expected, "costas group 16", group=16)
    check(costas16["launches"]["costas"] == 8,
          f"costas group 16: K4 launched {costas16['launches']['costas']} times, not 2 a group")
    for k in ALL_KERNELS:
        check(costas16["launches"][k] > 0, f"kernel {k} was not launched by the Costas group-16 step")
    same_rows(torch, rows16, costas_rows, "costas group 16 against group 0")
    for name, g16, g0 in (("V&V", fused16, fused), ("costas", costas16, costas)):
        log(f"  {name} group 16 against group 0: peak device memory {g16['peak_bytes'] / 2**30:.2f} "
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


def path_launches(torch, label: str, fn, need=(), show: bool = True):
    """Run ``fn`` with the launch counts set to 0 just before it and read
    just after; every kernel named in ``need`` must have been launched."""
    from gr4_packet_modem_tpu_torch.ops import _build

    _build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    if show:
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
    pkts, launches = path_launches(torch, "taps", lambda: srx.process(sig) + srx.flush(), ALL_KERNELS)
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
    (n, res), launches = path_launches(torch, "transceiver_4bins", lambda: fn(packets, gen), ALL_KERNELS)
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
        res, launches = path_launches(torch, label, run, ALL_KERNELS)
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
            torch, f"per {carrier}", lambda: per_curve(dev, points, carrier=carrier), ALL_KERNELS)
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
            for k in ALL_KERNELS:
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
    res, launches = path_launches(torch, "ReceiverBank.step", lambda: rbank.step(x_loc), ALL_KERNELS)
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
    dry, launches = path_launches(torch, "sharded_dryrun", lambda: sharded_dryrun(mesh, dev), ALL_KERNELS)
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
            check(all(r["launches"][k] > 0 for k in ALL_KERNELS), f"{world} ranks: a kernel was not launched")
        log(f"  {world} cards, mesh ({world // 2}, 2): {len(ranks[0]['keys'])} packets, those of StreamingBank; "
            f"{ranks[0]['blocks']} blocks in {ranks[0]['seconds']:.2f} s  [{card}]")
        out["multi_card"] = {"world": world, "seconds": ranks[0]["seconds"]}
    else:
        log(f"  multi-card: {cards} card here; the multi-rank path ran only on the CPU (gloo: "
            "tests/test_torch_parallel.py, _serving.py, _multihost.py)")
    return out


# ------------------------------------------------------------------ apps


def registry_checks(torch, card: str, dev) -> dict:
    """Every non-subsumed entry of the port's block registry resolves; the
    ops it resolves to run on the card and on CPU tensors from the same
    seeded numpy inputs: ``HeaderLdpcDecoder`` (B=1536, 25 iterations; bits
    and flags bit for bit, K5 launched once), ``BatchedCrcAppend`` /
    ``BatchedCrcCheck`` (four swap/skip options, exact), ``binary_slice``
    and ``descramble_soft`` (exact), ``pfb_symbol_filter`` (within 1e-5 of
    the largest output) and ``vv_phase_estimate`` (within 1e-5 rad). These
    launches are comparisons, not the main path's."""
    from gr4_packet_modem_tpu_torch import registry
    from gr4_packet_modem_tpu_torch.ops import _build, costas, crc, fir, ldpc, packing, scramble
    from gr4_packet_modem_tpu_torch.utils.firdes import rx_pfb_taps
    from gr4_packet_modem_tpu_torch.utils.stimulus import ldpc_encode_bytes

    cpu = torch.device("cpu")
    names = [k for k, e in registry.BLOCK_REGISTRY.items() if e.kind != "subsumed"]
    for k in names:
        check(registry.resolve(k) is not None, f"registry: {k} does not resolve")
    out = {"resolved": len(names)}

    def both(fn, *arrays):
        """``fn`` on the card and on the CPU: (card result on the host, CPU result)."""
        a = fn(*(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in arrays))
        b = fn(*(torch.from_numpy(np.ascontiguousarray(x)) for x in arrays))
        cast = (lambda t: [u.cpu() for u in t]) if isinstance(a, tuple) else (lambda t: t.cpu())
        return cast(a), b

    rng = np.random.default_rng(8)
    b = 1536
    headers = rng.integers(0, 256, (b, 4), dtype=np.uint8)
    cw = np.unpackbits(np.stack([ldpc_encode_bytes(h)[:16] for h in headers]), axis=1)
    sigma = np.sqrt(1.0 / (2 * 10 ** (rng.uniform(-6, 4, (b, 1)) / 10)))
    llr = ((2.0 / sigma**2) * (1.0 - 2.0 * cw + sigma * rng.standard_normal(cw.shape))).astype(np.float32)
    card_dec, cpu_dec = ldpc.HeaderLdpcDecoder(25, device=dev), ldpc.HeaderLdpcDecoder(25, device=cpu)
    before = _build.launch_counts()["ldpc"]
    bits, ok = card_dec.decode(torch.from_numpy(llr).to(dev))
    torch.cuda.synchronize()
    k5 = _build.launch_counts()["ldpc"] - before
    cbits, cok = cpu_dec.decode(torch.from_numpy(llr))
    check(k5 == 1, f"HeaderLdpcDecoder launched K5 {k5} times, not once")
    check(torch.equal(bits.cpu(), cbits) and torch.equal(ok.cpu(), cok),
          "HeaderLdpcDecoder: the card's bits or flags differ from the CPU's")
    out["header_decoder"] = {"batch": b, "ok": int(cok.sum()), "k5_launches": k5}
    log(f"  HeaderLdpcDecoder B={b}: bits and flags equal to the CPU's ({int(cok.sum())} ok), "
        f"K5 launched {k5}x")

    max_len, n = 1536, 64
    lens = rng.integers(8, max_len + 1, n).astype(np.int64)
    lens[:3] = [0, 3, 7]  # not longer than the skipped header or the CRC
    data = np.zeros((n, max_len), np.uint8)
    for i, m in enumerate(lens):
        data[i, :m] = rng.integers(0, 256, m, dtype=np.uint8)
    for swap in (False, True):
        for skip in (0, 3):
            app = crc.BatchedCrcAppend(max_len, swap, skip)
            (o, ol), (co, col) = both(app.append, data, lens)
            check(torch.equal(o, co) and torch.equal(ol, col), f"BatchedCrcAppend swap={swap} skip={skip}: card != CPU")
            bad = co.numpy().copy()
            bad[5, skip] ^= 0xFF
            for d in (co.numpy(), bad):
                (k_ok, k_out, k_len), (c_ok, c_out, c_len) = both(
                    crc.BatchedCrcCheck(max_len + 4, swap, skip).check, d, col.numpy())
                check(torch.equal(k_ok, c_ok) and torch.equal(k_out, c_out) and torch.equal(k_len, c_len),
                      f"BatchedCrcCheck swap={swap} skip={skip}: card != CPU")
            check(bool(c_ok[3:].sum() == n - 4) and not bool(c_ok[5]), "BatchedCrcCheck: wrong ok flags")
    log(f"  BatchedCrcAppend / BatchedCrcCheck ({n} packets up to {max_len} B, swap x skip): card == CPU")

    soft = rng.standard_normal((b, 2 * 6160)).astype(np.float32)
    for name, fn in (("binary_slice", packing.binary_slice), ("descramble_soft", scramble.descramble_soft)):
        a, c = both(fn, soft)
        check(torch.equal(a, c), f"{name}: card != CPU")
    x = (rng.standard_normal(1 << 16) + 1j * rng.standard_normal(1 << 16)).astype(np.complex64)
    taps = rx_pfb_taps(4, 32)
    a, c = both(lambda t: fir.pfb_symbol_filter(t, 20_000, 13, taps, 32, 6352), x)
    rel = float((a - c).abs().max() / c.abs().max())
    check(rel <= 1e-5, f"pfb_symbol_filter: card {rel:.3e} from the CPU's (> 1e-5 of the largest output)")
    a, c = both(lambda t: costas.vv_phase_estimate(t.view(8, -1)), x)
    rad = float((a - c).abs().max())
    check(rad <= 1e-5, f"vv_phase_estimate: card {rad:.3e} rad from the CPU's (> 1e-5)")
    out.update(pfb_symbol_filter_rel_err=rel, vv_phase_estimate_err_rad=rad)
    log(f"  binary_slice, descramble_soft exact; pfb_symbol_filter {rel:.3e} of the largest output; "
        f"vv_phase_estimate {rad:.3e} rad  [{card}]")
    return out


def quiet(*_):
    pass


def apps_phase(torch, card: str, dev, seconds: float = 3.0, count: int = 100,
               throttle_seconds: float = 2.0) -> dict:
    """The apps, driven in this process through their ``run()`` on the
    card at their own defaults (full width: 1536-byte payloads, 4
    frequency bins a side, fused acquisition, the Costas carrier):

    - the registry (:func:`registry_checks`);
    - ``packet_transmitter_pdu`` (``count`` x 1500 B, 16 a call) to a file
      under ``build/apps/``, burst and stream mode, then
      ``packet_receiver_file`` on it: every packet byte-exact at its sample
      index, through every kernel; its rate;
    - ``packet_transceiver`` in its self-test loopback (no TUN) at Es/N0 20
      dB, burst mode with CFO 0.005 and SFO 1.2 ppm and stream mode with
      CFO 0.005, each for ``seconds`` unthrottled and ``seconds`` at the
      app's 3.2 Msps: every packet sent received byte-exact after the
      flush, through all seven kernels; ``ProbeRate``'s average, packets/s,
      whether 3.2 Msps held, the median split of a loop (TX and channel
      together, throttle, RX); then the TX and the channel (with and
      without SFO) apart at the loop's shapes, each to a synchronise, with
      their device busy time and operations;
    - ``packet_transmitter_pdu_throttle`` for ``throttle_seconds`` at 3.2
      Msps: the achieved average beside the target.

    No TUN device is opened: ``io/tun.py::TunDevice`` needs CAP_NET_ADMIN,
    and only the CPU tests hold the native library (its SPSC ring)."""
    from gr4_packet_modem_tpu_torch.apps import (
        packet_receiver_file, packet_transceiver, packet_transmitter_pdu,
        packet_transmitter_pdu_throttle,
    )
    from gr4_packet_modem_tpu_torch.models.channel import awgn, rotate, sfo
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingTransmitter
    from gr4_packet_modem_tpu_torch.utils import constants as C

    out = {"registry": registry_checks(torch, card, dev)}
    device = ["--device", str(dev)]
    workdir = os.path.join(ROOT, "build", "apps")
    os.makedirs(workdir, exist_ok=True)
    payload = (np.arange(1500) % 256).astype(np.uint8)
    for mode in ("burst", "stream"):
        path = os.path.join(workdir, f"{mode}.c64")
        tx = packet_transmitter_pdu.run([path, mode, "1500", str(count), *device], echo=quiet)
        rx, launches = path_launches(
            torch, f"packet_receiver_file {mode}",
            lambda: packet_receiver_file.run([path, *device], echo=quiet), ALL_KERNELS)
        per = 4 * (C.stream_symbols(1500) if mode == "stream" else C.burst_symbols(1500))
        got = rx["packets"]
        check_all([p.data for p in got], [payload] * count, f"TX app -> file -> RX app, {mode}")
        check([p.index for p in got] == [k * per for k in range(count)],
              f"RX app {mode}: sample indices {[p.index for p in got][:4]}..., not k * {per}")
        log(f"  packet_receiver_file {mode}: {rx['samples']} samples in {rx['seconds']:.3f} s, "
            f"{rx['rate_sps']:.4e} samples/s (file read, receive and flush)  [{card}]")
        out[f"file_{mode}"] = {"samples": rx["samples"], "tx_samples": tx["samples"],
                               "seconds": rx["seconds"], "rate_sps": rx["rate_sps"],
                               "packets": rx["count"], "launches": launches}
        os.remove(path)

    target = 3.2e6
    for mode, extra in (("burst", ["--cfo", "0.005", "--sfo", "1.2"]), ("stream", ["--stream", "--cfo", "0.005"])):
        for rate_label, rate in (("unthrottled", 1e12), ("3.2Msps", target)):
            label = f"transceiver {mode} {rate_label}"
            argv = [*device, "--seconds", str(seconds), "--samp-rate", str(rate), *extra]
            res, launches = path_launches(
                torch, label, lambda: packet_transceiver.run(argv, echo=quiet), ALL_KERNELS)
            check(res["sent"] > 0 and res["received"] == res["sent"],
                  f"{label}: received {res['received']} of {res['sent']} packets")
            check_all([p.data for p in res["decoded"]], res["sent_payloads"], label)
            sps = res["samples"] / res["seconds"]
            pps = res["sent"] / res["seconds"]
            avg = res["reports"][-1].rate_avg if res["reports"] else float("nan")
            sp, mean = res["split_ms"], res["split_mean_ms"]
            r = {"sent": res["sent"], "loops": res["loops"], "seconds": res["seconds"],
                 "samples": res["samples"], "samples_per_s": sps, "packets_per_s": pps,
                 "rate_avg": avg, "split_ms": sp, "split_mean_ms": mean, "launches": launches}
            held = ""
            if rate == target:
                r["held_real_time"] = sps >= 0.98 * target
                held = f"; 3.2 Msps real time {'held' if r['held_real_time'] else 'NOT held'}"
            log(f"  {label}: {res['sent']} packets in {res['loops']} loops, {res['seconds']:.2f} s: "
                f"{sps:.4e} samples/s, {pps:.1f} packets/s, ProbeRate avg {avg:.4e}{held}"
                + "; loop split (median / mean ms): "
                + ", ".join(f"{k} {sp[k]:.3f} / {mean[k]:.3f}" for k in ("tx_channel", "throttle", "rx"))
                + f"  [{card}]")
            out[f"transceiver_{mode}_{rate_label}"] = r

    # the loop's TX and channel apart, at the app's shapes (4 x 256 B a
    # call): the app issues both and waits only at the host copy, so each is
    # timed here to a synchronise, with its device busy time and operations
    payloads = [(np.arange(256) + k).astype(np.uint8) for k in range(packet_transceiver.PACKETS_PER_LOOP)]
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = {}
    for mode in ("burst", "stream"):
        stx = StreamingTransmitter(Transmitter(TxConfig(max_payload_len=1536, stream_mode=mode == "stream"), dev))
        stages[f"tx_{mode}"] = getattr(stx, mode)
    sig = stages["tx_burst"](payloads)
    stages["channel_sfo"] = lambda _: awgn(rotate(sfo(sig, 1.2), 0.005), 0.01, gen)
    stages["channel"] = lambda _: awgn(rotate(sig, 0.005), 0.01, gen)
    split = {}
    for name, fn in stages.items():
        ms = median_ms(torch, lambda: fn(payloads))
        busy, ops = busy_ms(torch, lambda: fn(payloads))
        split[name] = {"ms": ms, "busy_ms": busy, "device_ops": ops}
    log("  transceiver loop stages (median ms to a synchronise; device busy ms in operations): "
        + ", ".join(f"{k} {v['ms']:.3f}; {v['busy_ms']:.3f} in {v['device_ops']:.0f}" for k, v in split.items())
        + f"  [{card}]")
    out["transceiver_stages"] = split

    res = packet_transmitter_pdu_throttle.run(["burst", str(target), *device], seconds=throttle_seconds,
                                              echo=quiet)
    avg = res["reports"][-1].rate_avg if res["reports"] else float("nan")
    log(f"  packet_transmitter_pdu_throttle: rate_avg {avg:.4e} against the target {target:.4e} "
        f"samples/s ({res['calls']} calls of 8 x 1500 B in {throttle_seconds:.0f} s)  [{card}]")
    out["throttle"] = {"target": target, "rate_avg": avg, "calls": res["calls"]}
    return out


# ------------------------------------------------------------------ examples

# the kernels each example must launch on the card (fused acquisition, the
# Costas carrier); the others run no kernel of the seven
EXAMPLE_KERNELS = {
    "syncword_detection": ("correlate", "fetch_rows"),
    "header_formatter": ("ldpc",),
    "header_roundtrip": ("ldpc",),
    **dict.fromkeys(("loopback", "streaming_blocks", "packet_ingress", "tun_loopback", "per_sweep",
                     "receiver_bank_serving", "sharded_bank", "sharded_serving"), ALL_KERNELS),
}


def example_outcome(name: str, res: dict, cpu: dict | None) -> str:
    """Check an example's result beyond its own checks; return a short
    account of it. ``cpu``: the same example's result on CPU tensors, for
    the examples compared with it."""
    from gr4_packet_modem_tpu_torch.utils import constants as C

    if name in ("header_formatter", "header_roundtrip"):
        check(np.array_equal(res["bits"], cpu["bits"]) and np.array_equal(res["ok"], cpu["ok"]),
              f"{name}: bits or flags differ from the CPU run's")
        return f"ok flags {res['ok'].tolist()}, bits and flags equal to the CPU run's"
    if name == "qpsk_modulator":
        check(np.array_equal(res["symbols"], cpu["symbols"]), "qpsk_modulator: symbols differ from the CPU's")
        return f"{res['symbols'].size} symbols equal to the CPU run's"
    if name == "syncword_detection":
        check(res["start"] == res["gap"] and abs(res["freq"] - res["cfo"]) < 1e-3 and res["esn0_db"] > 15,
              f"syncword_detection: {res}")
        return (f"start {res['start']}, freq {res['freq']:+.5f} (truth {res['cfo']:+.5f}), "
                f"amp {res['amp']:.3f}, esn0 {res['esn0_db']:.1f} dB")
    if name == "loopback":
        check(res["decoded"] == res["sent"], f"loopback: decoded {res['decoded']}")
        return f"decoded {res['decoded']}"
    if name == "streaming_blocks":
        sent = res["sent"]
        starts = np.cumsum([0] + [4 * C.burst_symbols(p.size) for p in sent[:-1]]).tolist()
        check([p.data.tobytes() for p in res["decoded"]] == [p.tobytes() for p in sent]
              and [p.index for p in res["decoded"]] == starts, "streaming_blocks: packets or indices differ")
        return f"{len(sent)}/{len(sent)} byte-exact at samples {starts}"
    if name == "packet_ingress":
        users = [p for p, t in zip(res["sent"], res["types"]) if t == int(C.PacketType.USER_DATA)]
        check([p.data.tobytes() for p in res["decoded"]] == [p.tobytes() for p in users],
              "packet_ingress: user packets differ")
        return f"{len(users)} user packets byte-exact, dropped {res['dropped']}, idle filtered"
    if name == "tun_loopback":
        check(res["rc"] == 0, f"tun_loopback: {res['ok']} of {len(res['sent'])} byte-exact")
        return f"demo {res['ok']}/{len(res['sent'])} IP packets byte-exact"
    if name == "per_sweep":
        rows = res["rows"]
        check(rows[0][1] == 1.0 and rows[-1][1] == 0.0, f"per_sweep: the ends {rows[0]}, {rows[-1]}")
        return "PER " + ", ".join(f"{e:.1f} dB {p:.3f}" for e, p in rows)
    if name in ("sharded_bank", "sharded_serving", "receiver_bank_serving"):
        least = res["expected"] - 3 if name == "receiver_bank_serving" else 3  # 3 payloads a channel
        check(min(res["per_channel"]) >= least, f"{name}: per-channel counts {res['per_channel']}")
        extra = ""
        if name == "receiver_bank_serving":
            rate = "none (step under the probe's 0.2 s)" if res["rate_avg"] is None else f"{res['rate_avg']:.6e}"
            extra = (f"; step {res['seconds']:.3f} s ({res['samples'] / res['seconds']:.4e} samples/s), "
                     f"ProbeRate avg {rate} samples/s")
        return f"mesh {res['mesh']}, {res['decoded']} packets, per channel {res['per_channel']}{extra}"
    return "own checks passed"


def examples_phase(torch, card: str, dev) -> dict:
    """Every example of ``gr4_packet_modem_tpu_torch/examples/`` through its
    ``run(["--device", "cuda"])`` in this process (``tun_loopback`` in its
    demo mode: ``--netns`` needs CAP_NET_ADMIN), the three mesh examples on
    one spawned NCCL rank (``--world 1``, a 1 x 1 mesh; a warm-up run of
    ``sharded_bank`` first), each with the
    launch counts set to 0 before it and read after: the kernels of
    :data:`EXAMPLE_KERNELS` must have been launched. The header examples'
    bits and flags and ``qpsk_modulator``'s symbols must equal their CPU
    runs'. One line an example: its wall time on the card (kernels built
    already), its outcome and its launches."""
    import importlib

    from gr4_packet_modem_tpu_torch.examples import EXAMPLES, MESH_EXAMPLES, _mesh
    from gr4_packet_modem_tpu_torch.ops import _build

    check((*ALL_KERNELS, "correlate_bf16") == _build.KERNELS,
          "chip_smoke.ALL_KERNELS and correlate_bf16 are not _build.KERNELS")
    out = {}

    def record(name, seconds, res, launches, cpu=None):
        for k in EXAMPLE_KERNELS.get(name, ()):
            check(launches[k] > 0, f"kernel {k} was not launched by example {name}")
        outcome = example_outcome(name, res, cpu)
        log(f"  {name}: {seconds:.3f} s, {outcome}; launches {launches}  [{card}]")
        out[name] = {"seconds": seconds, "outcome": outcome, "launches": launches}

    for name in EXAMPLES:
        if name in MESH_EXAMPLES:
            continue
        mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.examples.{name}")
        t0 = time.perf_counter()
        res, launches = path_launches(torch, name, lambda: mod.run(["--device", str(dev)], echo=quiet),
                                      EXAMPLE_KERNELS.get(name, ()), show=False)
        seconds = time.perf_counter() - t0
        cpu = (mod.run(["--device", "cpu"], echo=quiet)
               if name in ("header_formatter", "header_roundtrip", "qpsk_modulator") else None)
        record(name, seconds, res, launches, cpu)

    # the mesh examples on one spawned NCCL rank, one spawn for the three;
    # sharded_bank runs once first to take the fresh process's CUDA, FFT
    # and NCCL set-up, which the phases before took in this one
    jobs = [(f"gr4_packet_modem_tpu_torch.examples.{n}", ["--device", dev.type, "--world", "1"])
            for n in ("sharded_bank", *MESH_EXAMPLES)]
    t0 = time.perf_counter()
    warm, *results = _mesh.spawn(jobs, 1, dev.type, echo=quiet)
    log(f"  mesh examples: one spawned rank, {time.perf_counter() - t0:.1f} s with its start; "
        f"sharded_bank's warm-up run {warm['run_seconds']:.3f} s  [{card}]")
    out["mesh_warm_up_seconds"] = warm["run_seconds"]
    for name, res in zip(MESH_EXAMPLES, results):
        record(name, res["run_seconds"], res, res["rank_launches"][0])
    return out


# ---------------------------------------------------------------- benchmarks

BENCH_GATES = {  # bench's parity flags and the rates they gate
    "sustained_parity_ok": "sustained_stream_sps",
    "bank_sustained_parity_ok": "bank_sustained_sps",
    "sharded_parity_ok": "sharded_bank_sustained_sps",
}
ACQUIRE_KERNELS = {"fft": ("fetch", "fetch_rows"), "fused": ("correlate", "fetch", "fetch_rows")}


def benchmarks_phase(torch, card: str, dev) -> dict:
    """Every measurement program of the port at its own defaults, each in
    this process with the launch counts set to 0 before it and read after
    (``bench`` and ``benchmark_bank_scaling`` start and destroy their own
    NCCL world of one): ``bench`` (64 x 2**19, group 16, 20 iterations,
    the int8 wire, an 8-channel bank and sharded bank) with its three
    parity gates; ``benchmark_packet_receiver`` (4 bins, 8 channels,
    2**18); ``benchmark_syncword_detection`` (4 bins, 2**18) with fft and
    with fused acquisition; ``benchmark_packet_transceiver`` (4 bins, 24
    packets); ``benchmark_packet_transmitter_pdu`` burst and stream (64
    packets), one call's samples held within 1e-5 of the same call on CPU
    tensors; ``benchmark_bank_scaling`` (8 channels a card, 2**17). Each
    program's JSON line is printed as it printed it."""
    import importlib

    import torch.distributed as dist

    from gr4_packet_modem_tpu_torch.benchmarks.benchmark_packet_transmitter_pdu import tx_step

    check(not dist.is_initialized(), "benchmarks: a process group is still initialised")
    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("BENCH_")}
    out = {}

    def program(label: str, module: str, argv: list[str], need) -> dict:
        mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.{module}")
        t0 = time.perf_counter()
        rec, launches = path_launches(torch, label, lambda: mod.run(argv, device=str(dev), echo=False),
                                      need, show=False)
        seconds = time.perf_counter() - t0
        for line in rec.get("records", [rec]):
            log(f"  {json.dumps(line)}")
        log(f"  {label}: {seconds:.1f} s with its set-up; launches {launches}")
        out[label] = {"record": rec, "launches": launches, "seconds": seconds}
        return rec

    try:
        rec = program("bench", "bench", [], ALL_KERNELS)
        check(rec["decoded_packet_frac"] == 1.0, f"bench: decoded_packet_frac {rec['decoded_packet_frac']}")
        for gate, rate in BENCH_GATES.items():
            check(rec[gate] is True and rec[rate] > 0, f"bench: {gate} {rec[gate]}, {rate} {rec[rate]}")
        check(rec["value"] > 0 and rec["sharded_mesh"] == [1, 1], f"bench: {rec}")

        rec = program("packet_receiver", "benchmarks.benchmark_packet_receiver", [], ALL_KERNELS)
        check(rec["decoded_frac"] == 1.0, f"packet_receiver: decoded_frac {rec['decoded_frac']}")

        for backend, need in ACQUIRE_KERNELS.items():
            label = f"syncword_detection_{backend}"
            program(label, "benchmarks.benchmark_syncword_detection", ["4", backend], need)
            others = {k: n for k, n in out[label]["launches"].items() if n and k not in need}
            check(not others, f"{label}: launched {others} beside acquisition's kernels")

        rec = program("packet_transceiver", "benchmarks.benchmark_packet_transceiver", [], ALL_KERNELS)
        check(rec["decoded"] == rec["expected"] == 24, f"packet_transceiver: {rec['decoded']} of {rec['expected']}")

        for mode in ("burst", "stream"):
            program(f"tx_{mode}", "benchmarks.benchmark_packet_transmitter_pdu", [mode], ())
            fn, packets, n = tx_step(mode, 64, dev)
            cfn, cpackets, _ = tx_step(mode, 64, "cpu")
            (samples, lens), (want, want_lens) = fn(packets), cfn(cpackets)
            err = (samples.cpu() - want).abs().max().item()
            check(torch.equal(lens.cpu(), want_lens) and err <= 1e-5,
                  f"tx_{mode}: samples {err:.3e} from the CPU's, or lengths differ")
            out[f"tx_{mode}"].update(max_abs_err=err, samples_per_call=n)
            log(f"  tx_{mode}: one call's {n} samples within {err:.3e} of the CPU's")

        rec = program("bank_scaling", "benchmarks.benchmark_bank_scaling", [], ALL_KERNELS)
        got = [(r["devices"], r["efficiency"]) for r in rec["records"]]
        check(got == [(1, 1.0)], f"bank_scaling: records {got}")
    finally:
        os.environ.update(saved)
    check(not dist.is_initialized(), "benchmarks: a program left its process group")
    log(f"  benchmarks: every program passed its gates  [{card}]")
    return out


# --------------------------------------------------------------- envelope

# tests/test_large_payload.py's configurations: the u16 payload envelope
# (packet_ingress.hpp:104, at most 65,535 bytes)
ENVELOPE_CASES = {
    "u16_16k": dict(lengths=(16384, 5000), seed=7, max_len=16384, detections=4, bins=4,
                    cfo=0.002, noise=0.05),
    "u16_max": dict(lengths=(65535,), seed=11, max_len=65535, detections=2, bins=1,
                    cfo=0.001, noise=0.02),
}
KERNEL_SYMBOLS = {  # each kernel's __global__ function in csrc/
    "fetch": "fetch_regions_kernel", "fetch_rows": "fetch_rows_kernel",
    "matched": "matched_filter_kernel", "costas": "costas_kernel", "ldpc": "ldpc_kernel",
    "correlate": "correlate_kernel", "crc": "payload_crc_kernel",
}
TIMING_DELAYS = (-0.499, -0.45, -0.25, -0.05, 0.0, 0.05, 0.26, 0.45, 0.499)


def envelope_signal(dev, case: dict):
    """The port's transmitter on ``dev`` in burst mode, ``rotate`` by the
    case's CFO, then complex Gaussian noise from numpy (seed + 100).
    Returns (payloads, samples as numpy complex64)."""
    from gr4_packet_modem_tpu_torch.models.channel import rotate
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat

    rng = np.random.default_rng(case["seed"])
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in case["lengths"]]
    tx = Transmitter(TxConfig(max_payload_len=case["max_len"]), dev)
    s, n = tx.modulate_bursts(PacketBatch.from_list(payloads, case["max_len"], dev))
    x = rotate(ragged_concat(s, n, int(n.sum()))[0], case["cfo"]).cpu().numpy()
    rng = np.random.default_rng(case["seed"] + 100)
    x = x + case["noise"] * (rng.standard_normal(x.size) + 1j * rng.standard_normal(x.size))
    return payloads, x.astype(np.complex64)


def kernel_split(torch, fn, launches: dict, reps: int = 3) -> dict:
    """Device ms a call of ``fn`` for each kernel it launches: the mean of
    the kernel's torch.profiler records over ``reps`` calls (after a
    warm-up) times its launches a call (``launches``, one call's counts),
    with the records kept. The profiler now and then drops records (see
    ``timed``): up to four sessions run until each kernel has one; a kernel
    still without one gets ``ms`` None."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    want = {k: n for k, n in launches.items() if n}
    us = {k: [] for k in want}
    for _ in range(4):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for e in prof.events():
            for k in want:
                if e.device_type == cuda and KERNEL_SYMBOLS[k] in e.name:
                    us[k].append(e.time_range.elapsed_us())
        if all(us.values()):
            break
    missing = [k for k, v in us.items() if not v]
    if missing:
        log(f"  (profiler: no record of {missing} in four sessions)")
    return {k: {"ms": statistics.fmean(us[k]) * n / 1e3 if us[k] else None, "launches": n,
                "records": len(us[k])} for k, n in want.items()}


def envelope_work(rx, xp) -> list:
    """(part, kernel, (bytes, operations) a launch) of K1 in the
    acquisition of the padded capture ``xp`` and of the fused extraction
    (every chunk in one launch) and K4 in the payload pass, counted as
    ``_kernel_checks`` counts them (the extraction's rows apart in the
    capture, each row's span read once)."""
    cfg, a = rx.config, rx.acquirer
    d, kt, sps = cfg.max_detections, rx.arm_len, cfg.samples_per_symbol
    n, s, nb = a.config.fft_size, a.stride, a.num_bins
    fpad = a._frames_planes(xp.view(1, -1))[0].shape[0]
    syms = cfg.max_payload_syms
    chunk, chunks = rx._extraction_chunks(syms)
    samples = chunks * (sps * (chunk - 1) + kt)
    work = [
        ("acquire", "correlate", k1_work(fpad, s, n, nb)),
        ("payloads", "matched", (d * ((sps * (syms - 1) + kt) * 8 + 40 + syms * 8) + rx.arm_taps.numel() * 4,
                                 d * (samples * 48 + syms * 4 * kt))),
    ]
    if cfg.payload_carrier == "costas":
        work.append(("payloads", "costas", (2 * d * syms * 8 + 4 * d * 4, d * syms * (15 + 40))))
    return work


def envelope_kernel_rows(torch, card: str, rx, xp) -> list:
    """K1 and the fused extraction alone at the shapes of ``rx``'s receive
    of the padded capture ``xp`` (K1 on its frames, the extraction on the
    payload's slots at random starts, every chunk in one launch, its bound
    from the union of the samples they need), each against its plain
    version and timed with it as phase 3 times them."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power, fused_best_power_plain
    from gr4_packet_modem_tpu_torch.ops.matched_cuda import extract_symbols, extract_symbols_plain

    cfg, a, dev = rx.config, rx.acquirer, xp.device
    gen = torch.Generator(device=dev).manual_seed(cfg.max_payload_len)
    work = {k: w for _, k, w in envelope_work(rx, xp)}
    rows = []

    def row(name, shape, err, fn, plain, lib, nbytes=None):
        k = timed(torch, fn)
        pms = timed(torch, plain, reps=3)["ms"]
        lms = timed(torch, lib)["ms"] if lib else None
        bms, by = bound(work[name][0] if nbytes is None else nbytes, work[name][1])
        rows.append({"name": name, "shape": shape, "max_abs_err": err, **k, "plain_ms": pms,
                     "library_ms": lms, "bound_ms": bms, "bound_by": by})
        libs = f"{lms:.4f} ms" if lms is not None else "none"
        log(f"  {name:10s} {shape:34s} max_abs_err={err:.3e} kernel={k['ms']:.4f} ms ({k['timer']}, host "
            f"{k['host_ms']:.4f} ms/call) plain={pms:.4f} ms library={libs} bound={bms:.3e} ms "
            f"({by}, {100 * bms / k['ms']:.1f} % of it)  [{card}]")

    # K1 on the capture's frames
    n, s = a.config.fft_size, a.stride
    ar, ai, br, bi, nf, rows_c = a._frames_planes(xp.view(1, -1))
    args = (ar, ai, br, bi, a.replica_fft_r, a.replica_fft_i, n)
    kp, kb = (v.view(rows_c, n)[:nf, :s] for v in fused_best_power(*args, table=a.replica_table))
    pp, pb = (v.view(rows_c, n)[:nf, :s] for v in fused_best_power_plain(*args))
    check(torch.allclose(kp, pp, rtol=1e-4, atol=1e-5 * pp.max().item()),
          "correlate: best_pow beyond rtol 1e-4, atol 1e-5 x max")
    agree = (kb == pb).float().mean().item()
    check(agree >= 0.999, f"correlate: best_bin equal on {agree:.6f} < 0.999")
    row("correlate", f"FPAD={ar.shape[0]} S={s} N={n} nb={a.num_bins}", (kp - pp).abs().max().item(),
        lambda: fused_best_power(*args, table=a.replica_table), lambda: fused_best_power_plain(*args), None)
    del kp, kb, pp, pb

    # the fused extraction over the payload's slots, all chunks in one launch
    d, kt, sps = cfg.max_detections, rx.arm_len, cfg.samples_per_symbol
    syms = cfg.max_payload_syms
    chunk = rx._extraction_chunks(syms)[0]
    t = xp.numel()
    n_base = torch.randint(0, t - sps * (192 + syms), (d,), generator=gen, device=dev)
    n_base[0] = t - 700  # its chunks clamped at the capture's end
    ex = (xp.reshape(-1), t, n_base, None, torch.randint(0, rx.arm_taps.shape[0], (d,), generator=gen, device=dev),
          rx.arm_taps, 0.002 * torch.rand(d, generator=gen, device=dev) - 0.001, n_base - 5,
          0.5 + torch.rand(d, generator=gen, device=dev), sps, 192, syms, chunk)
    got, want = extract_symbols(*ex), extract_symbols_plain(*ex)
    check(torch.allclose(got, want, rtol=1e-5, atol=1e-4), f"extract S={syms}: beyond rtol 1e-5 atol 1e-4")
    row("matched", f"extract D={d} S={syms} chunk={chunk}", (got - want).abs().max().item(),
        lambda: extract_symbols(*ex), lambda: extract_symbols_plain(*ex), None,
        extraction_least_bytes(n_base.cpu().numpy(), None, t, kt, sps, 192, syms, chunk, rx.arm_taps.shape[0]))
    del got, want
    _flush.clear()  # so the next receive's peak device memory leaves it out
    return rows


def envelope_phase(torch, card: str, dev, chain) -> dict:
    """The u16 payload envelope through ``Transmitter.modulate_bursts``,
    ``rotate``, numpy noise and ``Receiver.receive`` on the card, both
    carriers; K4 at the full payload length; the 65,535-byte TX against
    the CPU; the symbol-timing sweep at the +-0.5-sample boundary."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track, costas_track_plain
    from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch
    from gr4_packet_modem_tpu_torch.utils.stimulus import costas_symbols

    out = {"cases": {}}
    for name, case in ENVELOPE_CASES.items():
        payloads, xn = envelope_signal(dev, case)
        xd = torch.from_numpy(xn).to(dev)
        for carrier in ("vv", "costas"):
            label = f"{name} {carrier}"
            cfg = RxConfig(max_payload_len=case["max_len"], max_detections=case["detections"],
                           freq_bins=case["bins"], payload_carrier=carrier, acquisition_backend="fused")
            rx = Receiver(cfg, dev)
            rx.receive(xd).accepted.sum().item()  # warm-up
            torch.cuda.reset_peak_memory_stats()
            res, launches = path_launches(torch, label, lambda: rx.receive(xd), ALL_KERNELS, show=False)
            peak = torch.cuda.max_memory_allocated()
            check_all(decoded(res), payloads, label)
            for p, n in zip(payloads, res.lengths[res.accepted].tolist()):
                check(n == p.size, f"{label}: length {n}, not {p.size}")
            chunks = rx._extraction_chunks(cfg.max_payload_syms)[1]
            check(launches["matched"] == 2 and launches["fetch"] == 1,
                  f"{label}: {launches['matched']} fused extractions and {launches['fetch']} K2 launches, "
                  f"not 2 and 1 ({chunks} payload chunks in one launch)")
            check(launches["costas"] == (2 if carrier == "costas" else 1),
                  f"{label}: K4 launched {launches['costas']} times")
            ms = median_ms(torch, lambda: rx.receive(xd).accepted.sum().item(), reps=3)
            busy, ops = busy_ms(torch, lambda: rx.receive(xd), reps=3)
            # device time a call of each kernel: the acquisition (K1, K2,
            # K2b), then the payload pass alone (the fused extraction of every
            # chunk, K4 in costas)
            xp = rx.pad(xd)
            det = rx.acquirer.acquire(xp)
            hdr, _ = rx.decode_headers(xp, det)
            _, keep = rx.filter_detections(det, hdr)
            _, acq_l = path_launches(torch, "acquire", lambda: rx.acquirer.acquire(xp), show=False)
            _, pay_l = path_launches(torch, "payloads", lambda: rx.decode_payloads(xp, det, hdr, keep),
                                     show=False)
            split = {"acquire": kernel_split(torch, lambda: rx.acquirer.acquire(xp), acq_l),
                     "payloads": kernel_split(torch, lambda: rx.decode_payloads(xp, det, hdr, keep), pay_l)}
            for part, k, (nbytes, nops) in envelope_work(rx, xp):
                row = split[part][k]
                row["bound_ms"], row["bound_by"] = bound(nbytes * row["launches"], nops * row["launches"])
            rows = {"valid": int(det.valid.sum()), "header_ok": int(hdr.header_ok.sum()),
                    "kept": int(keep.sum())}
            rec = {"receive_ms": ms, "busy_ms": busy, "device_ops": ops, "peak_bytes": peak,
                   "launches": launches, "payload_chunks": chunks, "samples": xn.size,
                   "padded": xp.shape[-1], "detections": case["detections"], "rows": rows,
                   "kernel_ms": split}
            log(f"  {label}: {len(payloads)} packets of {list(case['lengths'])} B decoded byte-exact; "
                f"receive {ms:.2f} ms (median of 3), device busy {busy:.2f} ms in {ops:.0f} operations, "
                f"peak device memory {peak / 2**20:.1f} MiB, {xn.size} samples; of "
                f"{case['detections']} slots {rows['valid']} valid, {rows['header_ok']} headers, "
                f"{rows['kept']} kept; launches {launches}; payload chunks {chunks}  [{card}]")
            log(f"  {label}: device ms a call (bound ms beside): " + "; ".join(
                f"{part} " + ", ".join(
                    f"{k} {v['ms'] if v['ms'] is None else round(v['ms'], 4)} x{v['launches']}"
                    + (f" ({v['bound_ms']:.4f}, {v['bound_by']})" if "bound_ms" in v else "")
                    for k, v in split[part].items())
                for part in ("acquire", "payloads")) + f"  [{card}]")
            # the card against the port's own CPU run on the same samples;
            # the 65,535-byte Costas case against the payload only (the
            # plain Costas loop's 262,156 steps are slow on the CPU)
            if not (name == "u16_max" and carrier == "costas"):
                t0 = time.perf_counter()
                want = Receiver(cfg, "cpu").receive(xn)
                rec["cpu_s"] = time.perf_counter() - t0
                acc = res.accepted.cpu()
                check(torch.equal(acc, want.accepted), f"{label}: accepted differs from the CPU's")
                for f in ("lengths", "data"):
                    check(torch.equal(getattr(res, f).cpu()[acc], getattr(want, f)[acc]),
                          f"{label}: {f} differ from the CPU's")
                log(f"  {label}: accepted, lengths and bytes equal to the CPU run's "
                    f"({rec['cpu_s']:.1f} s on the CPU)")
            if name == "u16_max" and carrier == "vv":
                out["kernel_rows"] = envelope_kernel_rows(torch, card, rx, xp)
            out["cases"][label] = rec
            del rx, res, xp, det, hdr, keep

    # K4 at the full 65,535-byte payload: one launch against two chained
    # through the loop state at a split off the 32-symbol tiles, and its
    # first 4,096 symbols against the plain loop, both bit for bit
    b, s, offset, cut = 2, 4 * (65535 + 4), 192, 100_003
    sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(b, s, offset, seed=65535))
    ko, kph, kfr = costas_track(sym, ph0, fr0, offset=offset)
    o1, p1, f1 = costas_track(sym[:, :cut].contiguous(), ph0, fr0, offset=offset)
    o2, p2, f2 = costas_track(sym[:, cut:].contiguous(), p1, f1, offset=offset + cut)
    check(torch.equal(ko, torch.cat([o1, o2], dim=1)) and torch.equal(kph, p2) and torch.equal(kfr, f2),
          f"costas S={s}: one launch differs from two chained at {cut}")
    head = 4096
    po, pph, pfr = costas_track_plain(sym[:, :head].contiguous(), ph0, fr0, offset=offset)
    ho, hph, hfr = costas_track(sym[:, :head].contiguous(), ph0, fr0, offset=offset)
    check(torch.equal(ko[:, :head], po) and torch.equal(ho, po) and torch.equal(hph, pph)
          and torch.equal(hfr, pfr), f"costas S={s}: the first {head} symbols differ from the plain loop")
    check(bool(torch.isfinite(torch.view_as_real(ko)).all()) and bool(torch.isfinite(kph).all()),
          f"costas S={s}: non-finite output")
    # CUDA events around back-to-back calls: at 0.5-40 ms a call the host's
    # time to issue one is small beside the kernel's (torch.profiler drops
    # most records of these long kernels)
    k4, k4_host = loop_ms(torch, lambda: costas_track(sym, ph0, fr0, offset=offset), reps=5)
    head_sym = sym[:, :head].contiguous()
    head_ms, _ = loop_ms(torch, lambda: costas_track(head_sym, ph0, fr0, offset=offset))
    plain_head_ms = event_ms(torch, lambda: costas_track_plain(head_sym, ph0, fr0, offset=offset), reps=1)
    floor = chain_floor(torch, chain, "pm_costas_chain", s, offset)
    bms, by = bound(2 * b * s * 8 + 4 * b * 4, b * s * (15 + 40))
    out["costas_full"] = {"shape": f"B={b} S={s} offset={offset}", "ms": k4, "host_ms": k4_host,
                          "chain_floor_ms": floor["ms"], "chain_cycles": floor["cycles"],
                          "sm_mhz": floor["sm_mhz"], "bound_ms": bms, "bound_by": by,
                          "chained_split": cut, "plain_symbols": head, "head_ms": head_ms,
                          "plain_head_ms": plain_head_ms}
    log(f"  costas B={b} S={s} offset={offset}: one launch equal bit for bit to two chained at {cut}; "
        f"the first {head} symbols equal to the plain loop; {k4:.4f} ms (CUDA events, 5 calls) "
        f"against its chain floor {floor['ms']:.4f} ms ({floor['cycles']} cycles at "
        f"{floor['sm_mhz']:.0f} MHz, {100 * floor['ms'] / k4:.1f} % of it), bound {bms:.4f} ms "
        f"({by}); on its first {head} symbols {head_ms:.4f} ms against the plain loop's "
        f"{plain_head_ms:.4f} ms  [{card}]")
    del sym, ko, o1, o2, po, ho, head_sym

    # K4 at u16_16k's Costas payload pass (four slots of 65,552 symbols):
    # alone, against its chain floor, and on its first 4,096 symbols beside
    # the plain loop, bit for bit
    b16, s16 = ENVELOPE_CASES["u16_16k"]["detections"], 4 * (16384 + 4)
    sym, ph0, fr0 = (torch.from_numpy(a).to(dev) for a in costas_symbols(b16, s16, offset, seed=16384))
    head_sym = sym[:, :head].contiguous()
    po, pph, pfr = costas_track_plain(head_sym, ph0, fr0, offset=offset)
    ho, hph, hfr = costas_track(head_sym, ph0, fr0, offset=offset)
    check(torch.equal(ho, po) and torch.equal(hph, pph) and torch.equal(hfr, pfr),
          f"costas B={b16} S={s16}: the first {head} symbols differ from the plain loop")
    k4, k4_host = loop_ms(torch, lambda: costas_track(sym, ph0, fr0, offset=offset), reps=5)
    head_ms, _ = loop_ms(torch, lambda: costas_track(head_sym, ph0, fr0, offset=offset))
    plain_head_ms = event_ms(torch, lambda: costas_track_plain(head_sym, ph0, fr0, offset=offset), reps=1)
    floor = chain_floor(torch, chain, "pm_costas_chain", s16, offset)
    bms, by = bound(2 * b16 * s16 * 8 + 4 * b16 * 4, b16 * s16 * (15 + 40))
    out["costas_16k"] = {"shape": f"B={b16} S={s16} offset={offset}", "ms": k4, "host_ms": k4_host,
                         "chain_floor_ms": floor["ms"], "chain_cycles": floor["cycles"],
                         "sm_mhz": floor["sm_mhz"], "bound_ms": bms, "bound_by": by,
                         "plain_symbols": head, "head_ms": head_ms, "plain_head_ms": plain_head_ms}
    log(f"  costas B={b16} S={s16} offset={offset}: the first {head} symbols equal to the plain loop; "
        f"{k4:.4f} ms (CUDA events, 5 calls) against its chain floor {floor['ms']:.4f} ms ({floor['cycles']} "
        f"cycles at {floor['sm_mhz']:.0f} MHz, {100 * floor['ms'] / k4:.1f} % of it), bound {bms:.4f} ms "
        f"({by}); on its first {head} symbols {head_ms:.4f} ms against the plain loop's "
        f"{plain_head_ms:.4f} ms  [{card}]")
    del sym, po, ho, head_sym

    # the transmitter at 65,535 bytes on the card against CPU tensors
    pays = [np.random.default_rng(ENVELOPE_CASES["u16_max"]["seed"]).integers(0, 256, 65535, dtype=np.uint8)]
    got, want = (Transmitter(TxConfig(max_payload_len=65535), d).modulate_bursts(
        PacketBatch.from_list(pays, 65535, d)) for d in (dev, "cpu"))
    err = (got[0].cpu() - want[0]).abs().max().item()
    check(torch.equal(got[1].cpu(), want[1]) and err <= 1e-5,
          f"tx 65535 B: samples {err:.3e} from the CPU's (> 1e-5), or lengths differ")
    out["tx_u16_max"] = {"samples": int(want[1].sum()), "max_abs_err": err}
    log(f"  tx 65535 B: {int(want[1].sum())} samples within {err:.3e} of the CPU's, lengths equal")

    out["timing"] = timing_sweep(torch, card, dev)
    return out


def frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    """Delay ``x`` by ``d`` samples (a phase ramp in frequency: exact for
    the RRC signal's < 0.25-Nyquist occupancy; tests/test_symbol_timing.py)."""
    n = 1 << int(np.ceil(np.log2(x.size + 256)))
    xp = np.zeros(n, np.complex128)
    xp[: x.size] = x
    f = np.fft.fftfreq(n)
    y = np.fft.ifft(np.fft.fft(xp) * np.exp(-2j * np.pi * f * d))
    return y[: x.size].astype(np.complex64)


def timing_sweep(torch, card: str, dev) -> dict:
    """tests/test_symbol_timing.py's sweep on the card: a clean 96-byte
    burst delayed by nine fractions of a sample, and at -0.45 with a CFO
    of 0.006, through ``acquire``, ``decode_headers``,
    ``filter_detections`` and ``decode_payloads``, held to the JAX
    test's bounds."""
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig
    from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig
    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.utils import constants as C
    from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat

    payload = (np.arange(96) % 256).astype(np.uint8)
    s, n = Transmitter(TxConfig(max_payload_len=128), dev).modulate_bursts(
        PacketBatch.from_list([payload], 128, dev))
    stream = ragged_concat(s, n, int(n.sum()))[0].cpu().numpy()
    clean = np.zeros(8192, np.complex64)
    clean[500 : 500 + stream.size] = stream
    rx = Receiver(RxConfig(max_payload_len=128, max_detections=4, freq_bins=1,
                           acquisition_backend="fused"), dev)
    _build.reset_launch_counts()
    rows = []
    for delay, cfo in [(d, 0.0) for d in TIMING_DELAYS] + [(-0.45, 0.006)]:
        x = frac_delay(clean, delay)
        x = (x * np.exp(1j * cfo * np.arange(x.size))).astype(np.complex64)
        xp = rx.pad(torch.from_numpy(x).to(dev))
        det = rx.acquirer.acquire(xp)
        hdr, corrected = rx.decode_headers(xp, det)
        _, keep = rx.filter_detections(det, hdr)
        res = rx.decode_payloads(xp, det, hdr, keep)
        te = float(det.time_est[0])
        sync = corrected[0, : C.SYNCWORD_LEN].cpu().numpy()
        label = f"timing delay {delay} cfo {cfo}"
        check(bool(det.valid[0]) and bool(hdr.header_ok[0]), f"{label}: no detection or header")
        check(bool(res.accepted[0]) and np.array_equal(res.data[0, : payload.size].cpu().numpy(), payload),
              f"{label}: payload not accepted byte-exact")
        if cfo == 0.0:
            err = (te - delay + 0.5) % 1.0 - 0.5
            evm = float(np.mean(np.abs(sync - 1.0) ** 2))
            check(abs(err) < 0.06 and evm < 0.005, f"{label}: time error {err:.4f}, syncword EVM {evm:.5f}")
            rows.append({"delay": delay, "time_est": te, "time_err": err, "sync_evm": evm})
        else:
            check(te < 0, f"{label}: time_est {te} not negative")
            tail = float(np.mean(np.abs(sync[48:] - np.mean(sync[48:])) ** 2))
            check(tail < 0.02, f"{label}: syncword tail EVM {tail:.5f}")
            rows.append({"delay": delay, "cfo": cfo, "time_est": te, "tail_evm": tail})
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    for k in ALL_KERNELS:
        check(launches[k] > 0, f"timing sweep: kernel {k} not launched")
    sweep = [r for r in rows if "sync_evm" in r]
    log(f"  timing: {len(sweep)} delays, |time error| <= {max(abs(r['time_err']) for r in sweep):.4f} "
        f"(< 0.06), syncword EVM <= {max(r['sync_evm'] for r in sweep):.5f} (< 0.005); CFO 0.006 at "
        f"-0.45: tail EVM {rows[-1]['tail_evm']:.5f} (< 0.02); every payload byte-exact; launches "
        f"{launches}  [{card}]")
    return {"rows": rows, "launches": launches}


# ------------------------------------------------------ acquisition backends

NEW_BACKENDS = ("fused_bf16", "conv", "conv_bf16")
# the JAX records' bf16 bench configurations (scripts/record_perf_r3.py:61-70)
BF16_BENCH = {
    "default_vv_bf16": {"BENCH_ACQ": "fused_bf16"},
    "ch64_g16_bf16": {"BENCH_CHANNELS": "64", "BENCH_ACQ": "fused_bf16", "BENCH_SUSTAINED": "0"},
}


def bf16_work(fpad: int, s: int, n: int, nb: int) -> tuple[float, float, float]:
    """(bytes, float32 operations, bf16 tensor-core operations) of K1's
    bf16 form on ``fpad`` frames: the frame views read once (2 planes,
    FPAD + 1 rows), the replica table and the two bf16 bulk tables read
    once, both outputs written once; a frame's (1 + nb) radix-16 DFTs as
    the kernel runs them (small_dft: 4 x 4 partial sums of 4 complex
    multiply-adds, 8 operations each, and a 4-point DFT of 16 operations
    for each of 4 rows: 576 operations a column) and its elementwise work
    (the forward twiddle, and a bin's product, twiddle, power and max: 6,
    6, 6, 3 and 1 an output); its (1 + nb) bulk products of 4 real
    [16, N2] @ [N2, N2] products (2 operations a multiply-add)."""
    n2 = n // 16
    small_dft = 4 * (4 * 4 * 8 + 16)
    nbytes = 2 * (fpad + 1) * s * 4 + nb * n * 8 + 2 * (2 * n2 * n2 * 2) + fpad * n * 8
    f32 = fpad * ((1 + nb) * n2 * small_dft + 6 * n + nb * n * 16)
    tc = fpad * (1 + nb) * 4 * 2 * 16 * n2 * n2
    return nbytes, f32, tc


def bf16_gate(torch, card: str, label: str, args, out) -> dict:
    """The output ``(best_pow, best_bin)`` of K1's bf16 form on the frame
    views and replica planes ``args`` against its plain version: every
    best power within 2e-2 of itself plus 1e-4 of the largest, every best
    bin equal where the plain version's best bin beats its second best by
    more than 5 % and by more than 2e-4 of the largest. Returns the largest
    deviations."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import bf16_bin_powers

    # the plain version's bin powers: its best (and bin) and second best
    powers = bf16_bin_powers(*args)
    top2, top_bin = powers.topk(min(2, powers.shape[0]), dim=0)
    del powers
    pp, pb = top2[0], top_bin[0].to(torch.int32)
    scale = pp.max().item()
    lim = 2e-2 * pp + 1e-4 * scale
    # a clear best bin: ahead of the second by more than 5 % of itself and
    # by more than twice best_pow's absolute tolerance (1e-4 x the largest),
    # the most two bins' errors can close
    ahead = top2[0] > 1.05 * top2[-1]
    clear = ahead & (top2[0] - top2[-1] > 2e-4 * scale)
    kp, kb = out
    err = (kp - pp).abs()
    worst = (err / lim).max().item()
    rel = (err / pp.clamp(min=1e-30)).max().item()
    same = kb == pb
    flips = ahead & ~same
    flip_top = (top2[0][flips].max().item() / scale) if bool(flips.any()) else 0.0
    log(f"  correlate_bf16 {label}: FPAD={pp.shape[0]} S={args[0].shape[1]} "
        f"nb={args[4].shape[0]}: max |d best_pow| {err.max().item():.3e} (largest {scale:.3e}), max "
        f"relative {rel:.3e}, the largest deviation {100 * worst:.1f} % of its limit; best_bin equal on "
        f"{same.float().mean().item():.6f} of all samples and on all {int(clear.sum())} samples with a "
        f"clear best bin ({100 * clear.float().mean().item():.1f} %); of the {int(ahead.sum())} whose best "
        f"bin leads by 5 %, {int(flips.sum())} differ, each at most {flip_top:.3e} of the largest  [{card}]")
    check(worst <= 1.0, f"correlate_bf16 {label}: best_pow beyond 2e-2 x itself + 1e-4 x max")
    check(bool(same[clear].all()), f"correlate_bf16 {label}: best_bin differs where the best bin is clear")
    return {"max_abs_err": err.max().item(), "max_rel_err": rel, "worst_of_limit": worst,
            "bin_equal_frac": same.float().mean().item(), "flips_5pct": int(flips.sum()),
            "flip_top_of_max": flip_top}


def bf16_kernel_check(torch, card: str, label: str, a, x) -> dict:
    """K1's bf16 form against its plain version (``bf16_gate``) on the
    acquirer ``a``'s frames of the padded bank ``x``. Returns the largest
    deviations and the frame views."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import fused_best_power

    n = a.config.fft_size
    ar, ai, br, bi, nf, rows = a._frames_planes(x)
    args = (ar, ai, br, bi, a.replica_fft_r, a.replica_fft_i, n)
    out = fused_best_power(*args, table=a.replica_table, bf16=True)
    torch.cuda.synchronize()
    res = bf16_gate(torch, card, label, args, out)
    return {**res, "args": args}


def bf16_size_report(torch, card: str, a, x, launch_floor: float) -> dict:
    """K1's bf16 form at the acquirer ``a``'s size (4096 or 8192) on its
    frames of the padded bank ``x``: the streaming kernel against the
    plain version (``bf16_gate``); then timed in turns with the float32
    K1 (streaming, K1, K1, streaming), each with its host time a call, its
    plain version's time and its bound (the bf16 form's three terms, K1's
    split-radix count)."""
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import (
        fused_best_power, fused_best_power_bf16_plain, fused_best_power_plain, replica_table,
    )

    n, s, nb = a.config.fft_size, a.stride, a.num_bins
    ar, ai, br, bi, nf, rows = a._frames_planes(x)
    fpad = ar.shape[0]
    args = (ar, ai, br, bi, a.replica_fft_r, a.replica_fft_i, n)
    f32_table = replica_table(a.replica_fft_r, a.replica_fft_i, n)

    def new():
        return fused_best_power(*args, table=a.replica_table, bf16=True)

    def f32():
        return fused_best_power(*args, table=f32_table)

    gate = bf16_gate(torch, card, f"N={n}", args, new())
    turns = [timed(torch, fn) for fn in (new, f32, f32, new)]
    k, f = mean_timed(turns[0], turns[3]), mean_timed(turns[1], turns[2])
    plain = timed(torch, lambda: fused_best_power_bf16_plain(*args), reps=3)["ms"]
    f32_plain = timed(torch, lambda: fused_best_power_plain(*args), reps=3)["ms"]
    work = bf16_work(fpad, s, n, nb)
    terms = bound_terms(*work)
    bms, by = bound(*work)
    f32_bms, f32_by = bound(*k1_work(fpad, s, n, nb))
    shape = f"C={x.shape[0]} FPAD={fpad} S={s} N={n} nb={nb}"
    log(f"  correlate_bf16 {shape} in turns (wgmma, K1, K1, wgmma): "
        + ", ".join(f"{t['ms']:.4f}" for t in turns) + " ms (" + ", ".join(t["timer"] for t in turns)
        + "); CUDA events around 10 calls: " + ", ".join(f"{t['loop_ms']:.4f}" for t in turns)
        + f" ms; wgmma {k['ms']:.4f} ms (host {k['host_ms']:.4f} "
        f"ms a call), {k['ms'] / f['ms']:.3f} x K1 ({f['ms']:.4f}, host {f['host_ms']:.4f}); plain "
        f"{plain:.4f} ms; bound {bms:.4f} ms ({by}: bytes {terms['bytes']:.4f}, float32 "
        f"{terms['f32']:.4f}, bf16 tensor cores {terms['bf16_tc']:.4f}; {100 * bms / k['ms']:.1f} % of "
        f"it); K1's bound {f32_bms:.4f} ms ({f32_by}, {100 * f32_bms / f['ms']:.1f} % of it), its plain "
        f"{f32_plain:.4f} ms; launch floor {launch_floor:.4f} ms  [{card}]")
    return {"shape": shape, "gate": gate, "turns_ms": [t["ms"] for t in turns],
            "turns_loop_ms": [t["loop_ms"] for t in turns],
            "wgmma": {**k, "bound_ms": bms, "bound_by": by, "bound_terms_ms": terms, "plain_ms": plain,
                      "max_abs_err": gate["max_abs_err"]},
            "f32": {**f, "bound_ms": f32_bms, "bound_by": f32_by, "plain_ms": f32_plain},
            "launch_floor_ms": launch_floor}


def bf16_kernel_report(torch, card: str) -> dict:
    """What the card gives K1's bf16 form at each size (registers and local
    bytes a thread, shared memory and threads a block, resident blocks and
    frames in flight an SM), the ptxas lines of its build, and the count of
    HGMMA (wgmma) and HMMA (mma.sync) instructions in each of its kernels'
    SASS (cuobjdump on the built library): the three kernels (N=2048, and
    the streaming one at 4096 and 8192) must each hold HGMMA."""
    import re

    from gr4_packet_modem_tpu_torch.ops import _build
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import KERNEL_FFT_SIZES, bf16_kernel_resources

    out = {"resources": {n: bf16_kernel_resources(n) for n in KERNEL_FFT_SIZES}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for n, r in out["resources"].items():
        log(f"  correlate_bf16 N={n}: {r['registers']} registers and {r['local_bytes']} local bytes a "
            f"thread, {r['shared_bytes']} B shared memory and {r['threads']} threads a block, "
            f"{r['blocks_per_sm']} block(s) and {r['frames_per_sm']} frames in flight an SM "
            f"({sms} SMs)  [{card}]")
    path = _build.library_path()
    lines, keep = [], False
    for line in path.with_suffix(".log").read_text().splitlines():
        if "correlate_bf16" in line:
            keep = True
            lines.append(line.strip())
        elif keep and ("spill" in line or "Used" in line):
            lines.append(line.strip())
        else:
            keep = False
    for line in lines:
        log(f"  ptxas: {line}")
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(path)], capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if "correlate_bf16" in m.group(1) else None
            if fn:
                counts[fn] = {"HGMMA": 0, "HMMA": 0}
        elif fn:
            for op in counts[fn]:
                counts[fn][op] += bool(re.search(rf"\b{op}\.", line))
    for name, c in counts.items():
        short = re.sub(r".*(correlate_bf16_(wgmma|stream\w*?Li\d+)).*", r"\1", name)
        log(f"  SASS {short}: {c['HGMMA']} HGMMA, {c['HMMA']} HMMA")
    kinds = sorted(re.sub(r".*correlate_bf16_(wgmma|stream\w*?Li\d+).*", r"\1", name) for name in counts)
    check(kinds == ["streamILi256", "streamILi512", "wgmma"] and all(c["HGMMA"] > 0 for c in counts.values()),
          f"correlate_bf16: a kernel at N=2048, 4096 or 8192 is missing or has no HGMMA in its SASS: {counts}")
    out["ptxas"] = lines
    out["sass"] = counts
    return out


def backends_phase(torch, card: str, dev, launch_floor: float) -> dict:
    """The acquisition backends the port once refused: K1's bf16 form
    against its plain version at the bench shape, timed in turns with the
    float32 K1, and at N=4096 and 8192 on the bench bank as a Receiver with
    that ``acquisition_fft_size`` pads it (``bf16_size_report``); ``bank_step`` of the bench bank with
    fused_bf16, conv and conv_bf16 (group 0), each held to the fused
    backend's detections and decoding every packet, and at N=4096 and 8192
    with fused and fused_bf16, the two alike; ``bench`` at the JAX
    records' two bf16 configurations; the syncword program with all five
    backends."""
    import importlib

    from gr4_packet_modem_tpu_torch.entry import BENCH_BLOCK, BENCH_CHANNELS, BENCH_CONFIG
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver
    from gr4_packet_modem_tpu_torch.ops.acquire_cuda import (
        STREAM_FFT_SIZES, fused_best_power, fused_best_power_bf16_plain, replica_table,
    )

    out = {"kernel": bf16_kernel_report(torch, card)}
    gen = torch.Generator(device=dev).manual_seed(4321)
    samples, expected, _ = bench_signal(BENCH_BLOCK, BENCH_CHANNELS)
    rx = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_backend="fused_bf16"), dev)

    def padded(sig, noise, r=rx):
        fp, pt = r.front_pad, r.pad_tail()
        x = torch.zeros(sig.shape[0], fp + sig.shape[1] + pt, dtype=torch.complex64, device=dev)
        x[:, fp : fp + sig.shape[1]] = torch.from_numpy(sig).to(dev)
        if noise:
            x += noise * torch.randn(x.shape, generator=gen, device=dev, dtype=torch.complex64)
        return x

    # (a) the kernel against its plain version; (b) timed in turns with K1
    x = padded(samples, 0.05)
    main = bf16_kernel_check(torch, card, "N=2048", rx.acquirer, x)
    args = main.pop("args")
    a = rx.acquirer
    n, s, nb, fpad = a.config.fft_size, a.stride, a.num_bins, args[0].shape[0]
    f32_table = replica_table(a.replica_fft_r, a.replica_fft_i, n)

    def bf16_call():
        return fused_best_power(*args, table=a.replica_table, bf16=True)

    def f32_call():
        return fused_best_power(*args, table=f32_table)

    k1, f1, k2, f2 = (timed(torch, fn) for fn in (bf16_call, f32_call, bf16_call, f32_call))
    k = mean_timed(k1, k2)
    f32_ms = (f1["ms"] + f2["ms"]) / 2
    plain = timed(torch, lambda: fused_best_power_bf16_plain(*args), reps=3)["ms"]
    work = bf16_work(fpad, s, n, nb)
    terms = bound_terms(*work)
    bms, by = bound(*work)
    log(f"  correlate_bf16 in turns with the float32 K1: {k1['ms']:.4f}, {f1['ms']:.4f}, {k2['ms']:.4f}, "
        f"{f2['ms']:.4f} ms (bf16/f32 {k['ms'] / f32_ms:.3f}); host {k['host_ms']:.4f} ms a call, "
        f"loop {k['loop_ms']:.4f}; plain {plain:.4f} ms; bound {bms:.4f} ms ({by}: bytes "
        f"{terms['bytes']:.4f}, float32 {terms['f32']:.4f}, bf16 tensor cores {terms['bf16_tc']:.4f}; "
        f"{100 * bms / k['ms']:.1f} % of it); launch floor {launch_floor:.4f} ms  [{card}]")
    out["correlate_bf16"] = {**main, "ms": k["ms"], "host_ms": k["host_ms"], "loop_ms": k["loop_ms"],
                             "turns_ms": [k1["ms"], f1["ms"], k2["ms"], f2["ms"]], "f32_ms": f32_ms,
                             "plain_ms": plain, "library_ms": None, "bound_ms": bms, "bound_by": by,
                             "bound_terms_ms": terms, "launch_floor_ms": launch_floor,
                             "shape": f"C={BENCH_CHANNELS} FPAD={fpad} S={s} N={n} nb={nb}"}
    del x, args
    # (a, b) at N=4096 and 8192: the bench bank as a Receiver with that
    # acquisition_fft_size pads it
    for size in STREAM_FFT_SIZES:
        rxn = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_fft_size=size,
                                           acquisition_backend="fused_bf16"), dev)
        x = padded(samples, 0.05, rxn)
        r = bf16_size_report(torch, card, rxn.acquirer, x, launch_floor)
        out[f"correlate_bf16_{size}"] = r
        res = out["correlate_bf16"]
        res["max_abs_err"] = max(res["max_abs_err"], r["wgmma"]["max_abs_err"])
        del rxn, x
        _flush.clear()

    # (c) the bench bank with each new backend, against the fused backend
    x = padded(samples, 0.0)
    rx_fused = Receiver(BENCH_CONFIG, dev)
    ref = rx_fused.bank_step(x, 0)[0]
    del rx_fused
    want = {"fused_bf16": ("correlate_bf16",), "conv": (), "conv_bf16": ()}
    rows = {}
    for backend in NEW_BACKENDS:
        rxb = rx if backend == "fused_bf16" else Receiver(
            dataclasses.replace(BENCH_CONFIG, acquisition_backend=backend), dev)
        r, (det, _, _) = bank_run(torch, card, rxb, x, expected, backend)
        launches = r["launches"]
        for k_ in ("fetch", "fetch_rows", "matched", "costas", "ldpc", *want[backend]):
            check(launches[k_] > 0, f"{backend}: kernel {k_} was not launched by the bank step")
        check(launches["correlate"] == 0, f"{backend}: the float32 K1 was launched")
        if backend != "fused_bf16":
            check(launches["correlate_bf16"] == 0, f"{backend}: K1's bf16 form was launched")
        check(torch.equal(det.valid, ref.valid), f"{backend}: valid differs from the fused backend's")
        for f in ("index", "freq_bin"):
            check(torch.equal(getattr(det, f)[ref.valid], getattr(ref, f)[ref.valid]),
                  f"{backend}: {f} differs from the fused backend's")
        log(f"  {backend}: detections equal to the fused backend's on all {int(ref.valid.sum())} valid rows")
        rows[backend] = r
        del rxb, det
    out["bank"] = rows
    out["launches_per_step"] = rows["fused_bf16"]["launches"]["correlate_bf16"]
    del x, ref

    # (c') the bench bank at acquisition_fft_size 4096 and 8192 with both K1
    # forms: every packet, the same detections, the right K1 launched
    for size in STREAM_FFT_SIZES:
        rows, dets = {}, {}
        for backend in ("fused", "fused_bf16"):
            rxb = Receiver(dataclasses.replace(BENCH_CONFIG, acquisition_fft_size=size,
                                               acquisition_backend=backend), dev)
            x = padded(samples, 0.0, rxb)
            # the bf16 form's rounding-error events in the zero padding may
            # outnumber the slots left; the slots go to the strongest events,
            # and the capture's detections are held to fused's below
            r, (det, _, _) = bank_run(torch, card, rxb, x, expected, f"{backend} N={size}",
                                      overflow_ok=backend == "fused_bf16")
            launches = r["launches"]
            for k_ in ("fetch", "fetch_rows", "matched", "costas", "ldpc"):
                check(launches[k_] > 0, f"{backend} N={size}: kernel {k_} was not launched by the bank step")
            want_k1 = {"correlate": 1, "correlate_bf16": 0} if backend == "fused" else {"correlate": 0, "correlate_bf16": 1}
            check(all(launches[k_] == v for k_, v in want_k1.items()),
                  f"{backend} N={size}: K1 launches {launches['correlate']}, its bf16 form {launches['correlate_bf16']}")
            rows[backend], dets[backend] = r, det
            del rxb, x
        # the same (index, bin) detections on every channel inside the
        # capture (so no slot the bf16 form's extra events took was one of
        # them); past its end, in the zero padding, both forms detect their
        # own rounding error (the bf16 form's, as the JAX kernel's in exact
        # silence: tests/test_torch_acquire_backends.py::
        # test_silent_tail_detections_equal_jax), and none decodes
        end = rx.front_pad + BENCH_BLOCK
        sets = {k: [{(i, b) for i, b, v in zip(d.index.view(BENCH_CHANNELS, -1)[c].tolist(),
                                                 d.freq_bin.view(BENCH_CHANNELS, -1)[c].tolist(),
                                                 d.valid.view(BENCH_CHANNELS, -1)[c].tolist()) if v}
                     for c in range(BENCH_CHANNELS)] for k, d in dets.items()}
        inside = tail = 0
        for c in range(BENCH_CHANNELS):
            sa, sb = sets["fused"][c], sets["fused_bf16"][c]
            check({d for d in sa if d[0] < end} == {d for d in sb if d[0] < end},
                  f"N={size} channel {c}: fused_bf16's detections inside the capture differ from fused's")
            inside += sum(d[0] < end for d in sa)
            tail += len(sa ^ sb)
        log(f"  N={size}: fused_bf16's detections equal to fused's on all {inside} inside the capture; "
            f"{tail} differ in the zero padding past its end ({end}), none decoded")
        rows["inside_equal"], rows["tail_differ"] = inside, tail
        out[f"bank_{size}"] = rows
        del dets

    # (d) bench at the two bf16 configurations; (e) the syncword program
    import torch.distributed as dist

    check(not dist.is_initialized(), "backends: a process group is still initialised")
    saved = {k_: os.environ.pop(k_) for k_ in list(os.environ) if k_.startswith("BENCH_")}
    need_rx = ("fetch", "fetch_rows", "matched", "costas", "ldpc", "correlate_bf16")
    try:
        bench = importlib.import_module("gr4_packet_modem_tpu_torch.bench")
        for name, knobs in BF16_BENCH.items():
            os.environ.update(knobs)
            t0 = time.perf_counter()
            rec, launches = path_launches(torch, name, lambda: bench.run([], device=str(dev), echo=False),
                                          need_rx, show=False)
            for k_ in knobs:
                os.environ.pop(k_)
            log(f"  {json.dumps(rec)}")
            log(f"  {name}: {time.perf_counter() - t0:.1f} s with its set-up; launches {launches}")
            check(launches["correlate"] == 0, f"{name}: the float32 K1 was launched")
            check(rec["acq_backend"] == "fused_bf16" and rec["decoded_packet_frac"] == 1.0,
                  f"{name}: {rec['acq_backend']}, decoded_packet_frac {rec['decoded_packet_frac']}")
            for gate, rate in BENCH_GATES.items():
                if gate in rec:
                    check(rec[gate] is True and rec[rate] > 0, f"{name}: {gate} {rec[gate]}, {rate} {rec[rate]}")
            check(("sustained_parity_ok" in rec) == (name == "default_vv_bf16"), f"{name}: sustained run")
            out[name] = {"record": rec, "launches": launches}
        sync = importlib.import_module("gr4_packet_modem_tpu_torch.benchmarks.benchmark_syncword_detection")
        acquire_kernels = {**ACQUIRE_KERNELS, "fused_bf16": ("correlate_bf16", "fetch", "fetch_rows"),
                           "conv": ("fetch", "fetch_rows"), "conv_bf16": ("fetch", "fetch_rows")}
        for backend, need in acquire_kernels.items():
            label = f"syncword_detection_{backend}"
            rec, launches = path_launches(torch, label, lambda: sync.run(["4", backend], device=str(dev), echo=False),
                                          need, show=False)
            others = {k_: v for k_, v in launches.items() if v and k_ not in need}
            check(not others, f"{label}: launched {others} beside acquisition's kernels")
            log(f"  {json.dumps(rec)}")
            out[label] = {"record": rec, "launches": launches}
    finally:
        os.environ.update(saved)
    check(not dist.is_initialized(), "backends: bench left its process group")
    _flush.clear()
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
    with ThreadPoolExecutor(1) as pool:
        job = pool.submit(build_chain_probe)
        path = _build.build()
        chain = job.result()
    _build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s -> {os.path.relpath(path, ROOT)} and the chain probe")
    for line in path.with_suffix(".log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log(f"  {line.strip()}")

    # phase 3: kernels vs plain versions
    log("kernels:")
    kres = kernel_checks(torch, card, chain)

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

    # phase 11: the registry's ops and the apps
    log("apps:")
    appres = apps_phase(torch, card, dev)

    # phase 12: the examples
    log("examples:")
    exres = examples_phase(torch, card, dev)

    # phase 13: the measurement programs
    log("benchmarks:")
    benchres = benchmarks_phase(torch, card, dev)

    # phase 14: the u16 payload envelope and the timing boundary
    log("envelope:")
    t0 = time.perf_counter()
    envres = envelope_phase(torch, card, dev, chain)
    envres["seconds"] = time.perf_counter() - t0
    log(f"  envelope: {envres['seconds']:.1f} s")

    # phase 15: the acquisition backends fused_bf16, conv and conv_bf16
    log("backends:")
    t0 = time.perf_counter()
    backres = backends_phase(torch, card, dev, kres["launch_floor_ms"])
    backres["seconds"] = time.perf_counter() - t0
    log(f"  backends: {backres['seconds']:.1f} s")
    import gr4_packet_modem_tpu_torch.io.zmq_pub  # noqa: F401  (the taps' publisher, no pyzmq here)

    check("jax" not in sys.modules, "jax was imported")
    jax_package = sorted(m for m in sys.modules if m.split(".")[0] == "gr4_packet_modem_tpu")
    check(not jax_package, f"modules of the JAX package were imported: {jax_package}")

    # each kernel's launches on its main path: the fused bank step of phase
    # 4, and phase 15's fused_bf16 bank step for K1's bf16 form
    main_launches = {**sres["fused"]["launches"],
                     "correlate_bf16": backres["launches_per_step"]}
    numbers = {**kres, "correlate_bf16": backres["correlate_bf16"]}
    kernels = [
        {"name": k, "route": "cuda", "source": REPLACES[k][0],
         "replaces": REPLACES[k][1], "launches": main_launches[k],
         **{f: numbers[k][f] for f in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")}}
        for k in _build.KERNELS
    ]
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "kernels": kernels, "kernel_rows": kres["rows"],
                   "launch_floor_ms": kres["launch_floor_ms"], "slice": sres,
                   "streaming": stres, "taps": tapres, "tx": txres, "transceiver": trxres,
                   "per": perres, "sharded": shres, "apps": appres, "examples": exres,
                   "benchmarks": benchres, "envelope": envres, "backends": backres,
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
