"""Transceiver entry: upstream's packet transceiver on a bank of links, run
through the port's own ``TransceiverBank`` (``models/transceiver.py``).
Each step hands the program one step's payloads from pinned host memory;
the program transmits them, impairs them and decodes them with the graphed
``Receiver.bank_step``, and returns the accepted packets on the host. This
entry holds no transmitter or channel of its own.

The mix's keys, beside ``entry``, ``channels``, ``payload_len``, ``pool``,
``cfo`` and ``noise`` (as ``traffic.py`` has them):

- ``bursts``: whole bursts a link a step, back to back from the link's
  offset, drawn uniformly over the block's slack (the block less the
  bursts);
- ``blocks``: step sets, each ``[channels, bursts]`` payloads drawn from
  the pool and staged in pinned host memory; the steps cycle through them.

Each link's offset, carrier offset (uniform in ``[-cfo, cfo]``
rad/sample) and phase (uniform) are drawn anew for each step, from a table
of ``LINK_DRAWS`` steps' draws made from the seed at set-up and staged in
pinned host memory. The noise comes from the program's generator, seeded
from the seed. The loop is closed: a step starts when the last one's
packets are on the host. Its latency runs from handing the step's inputs
to the program to its packets on the host; ``rx_sps`` counts the bank's
channel-samples (channels x block) of every step completed in the window.

Set-up runs ``WARM_STEPS`` steps, so that the receiver's graphs are
captured and every shape has run. After a sampled step (the window's
first, ``SAMPLED_STEPS - 1`` drawn from its first 64, and its last) the
program's TX bank and received bank are copied on the card into buffers
allocated at set-up (staged bytes, left out of ``peak_mem_gib``), and the
generator's state before the step is kept. After the window, with the
program's state freed:

- the sampled steps' packets against the payloads handed in (``missed``,
  ``false``, ``dup``);
- ``tx_diff``: the largest ``|program TX bank - ReferenceTransmitter's|``
  from the same payloads, offsets and GLFSR indices (every step sends
  ``bursts`` packets a link, so packet k of step i takes ``i * bursts +
  k``);
- ``channel_diff``: the largest ``|program received bank - reference
  channel of the program's TX bank|`` (same offsets, phases and noise
  draws);
- ``det_diff``, ``row_diff``, ``esn0_gap_db``: the program's rows against
  ``ReferenceReceiver`` on the program's received bank;
- ``tx_packets_gap``: the program's counter ``tx.packets`` over the window
  against the packets handed to it.

Hooks (the CPU tests): ``fault(loop)`` installs a fault on the program's
object; ``warm_steps`` cuts the warm-up; ``reference_dtype`` (a torch
dtype's name) computes the reference TX and channel in a lower precision,
for the control reading of the limits.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from h100_bench import correct, traffic, tx_work, work
from h100_bench.entries.resident import _rows
from h100_bench.reference import constants as RC
from h100_bench.reference.receiver import ReferenceReceiver
from h100_bench.reference.transmitter import ReferenceTransmitter, channel
from h100_bench.trace import Spans, profile_steps

PROFILED_STEPS = 5
WARM_STEPS = 48
SAMPLED_STEPS = 4
LINK_DRAWS = 4096


def setup(ctx):
    # the program's bank loop; a program without it stops here
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank
    from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig
    from gr4_packet_modem_tpu_torch.utils import trace as program_trace

    dev, cfg, mix = ctx.device, ctx.config, ctx.mix
    c, k, block = int(mix["channels"]), int(mix["bursts"]), int(cfg["block"])
    length, sps = int(mix["payload_len"]), int(cfg["tx"].get("samples_per_symbol", 4))
    burst_len = sps * RC.burst_symbols(length)
    slack = block - k * burst_len
    if slack < 0:
        raise ValueError(f"{k} bursts of {burst_len} samples do not fit a block of {block}")
    loop = TransceiverBank(TxConfig(**cfg["tx"]), RxConfig(**cfg["rx"]), c, k, block, dev,
                           noise=float(mix["noise"]), group=int(cfg.get("group", 0)),
                           generator=traffic.torch_generator(ctx.seed, dev))
    if "fault" in ctx.hooks:
        ctx.hooks["fault"](loop)
    ctx.mark("program")
    pin = dev.type == "cuda"
    rng = traffic.rng_for(ctx.seed, 1)
    pool = rng.integers(0, 256, (int(mix["pool"]), length), dtype=np.uint8)
    sets, ids = [], []
    for _ in range(int(mix["blocks"])):
        pid = rng.integers(0, len(pool), (c, k))
        data = np.zeros((c, k, int(cfg["tx"]["max_payload_len"])), np.uint8)
        data[..., :length] = pool[pid]
        sets.append((torch.from_numpy(data).pin_memory() if pin else torch.from_numpy(data),
                     torch.full((c, k), length, dtype=torch.int64, pin_memory=pin)))
        ids.append(pid)
    rng = traffic.rng_for(ctx.seed, 2)
    draws = {"offset": rng.integers(0, slack + 1, (LINK_DRAWS, c)),
             "cfo": rng.uniform(-float(mix["cfo"]), float(mix["cfo"]), (LINK_DRAWS, c)),
             "phase": rng.uniform(-np.pi, np.pi, (LINK_DRAWS, c))}
    staged = {name: torch.from_numpy(a).pin_memory() if pin else torch.from_numpy(a) for name, a in draws.items()}
    ctx.mark("traffic")

    spans = Spans(torch, on=False)
    if ctx.trace:  # a run that reads no per-layer metric runs the program unwrapped
        spans.wrap(loop.rx.acquirer, "acquire", "acquire")
        spans.wrap(loop.rx, "decode_headers", "headers")
        spans.wrap(loop.rx, "decode_payloads", "payload")
        spans.wrap(loop, "transmit", "tx")
        spans.wrap(loop, "impair", "channel")
        spans.wrap(loop, "to_host", "to_host")
    st = {"loop": loop, "sets": sets, "ids": ids, "pool": pool, "draws": draws, "spans": spans,
          "burst_len": burst_len, "block": block, "i": 0}

    def step():
        i = st["i"]
        data, lengths = sets[i % len(sets)]
        s = i % LINK_DRAWS
        out = loop.step(data, lengths, staged["offset"][s], staged["cfo"][s], staged["phase"][s])
        st["i"] = i + 1
        return out

    st["step"] = step
    for _ in range(int(ctx.hooks.get("warm_steps", WARM_STEPS))):
        step()
    # the check's copies: buffers of their own, counted as staged
    slots = SAMPLED_STEPS + 1
    st["tx_buf"] = torch.empty(slots, c, block, dtype=torch.complex64, device=dev)
    st["rx_buf"] = torch.empty(slots, *loop.bank.shape, dtype=torch.complex64, device=dev)
    st["staged_bytes"] = sum(b.numel() * b.element_size() for b in (st["tx_buf"], st["rx_buf"]))
    if dev.type == "cuda":
        ctx.record["setup_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    rx, acq = loop.rx, loop.rx.acquirer
    rows = c * rx.config.max_detections
    nbytes, ops = work.acquire_work(c, loop.bank.shape[1], acq.config.fft_size, acq.sync_len, acq.num_bins,
                                    rx.config.max_detections)
    k4 = work.costas_bytes(rows, 192)
    if rx.config.payload_carrier == "costas":
        k4 += work.costas_bytes(rows, rx.config.max_payload_syms)
    ctx.record["work"] = {"acquire_least_s": work.least_s(nbytes, ops), "k4_least_s": work.least_s(k4, 0),
                          "tx_least_s": work.least_s(tx_work.tx_bytes(c * k * length, c, block), 0)}
    st["program_trace"] = program_trace
    return st


def window(ctx, st, seconds: float) -> None:
    torch_, rec = ctx.torch, ctx.record
    loop, step, spans = st["loop"], st["step"], st["spans"]
    rng = traffic.rng_for(ctx.seed, 3)
    sample = {0, *rng.choice(np.arange(1, 64), SAMPLED_STEPS - 1, replace=False).tolist()}
    kept = {}

    def keep(slot: int, out, host, gen_state) -> None:
        st["tx_buf"][slot].copy_(loop.tx_bank)
        st["rx_buf"][slot].copy_(loop.bank)
        kept[slot] = (st["i"] - 1, out, host, gen_state)

    lat = []
    spans.on = ctx.trace
    profile_at = seconds / 3 if ctx.trace else float("inf")
    packets0 = st["program_trace"].counters().get("tx.packets", 0)
    i0 = st["i"]
    k = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t - t0 >= profile_at:
            profile_at = float("inf")
            rec["profile"], ran = profile_steps(torch_, step, PROFILED_STEPS)
            k += ran  # profiled steps count as work of the window, not as latencies
            continue
        state = loop.generator.get_state()  # a host copy of its seed and offset
        out, host = step()
        lat.append(time.perf_counter() - t)
        if k in sample:
            keep(len(kept), out, host, state)
        k += 1
        if time.perf_counter() >= t_end:
            break
    rec["window_s"] = time.perf_counter() - t0
    keep(SAMPLED_STEPS, out, host, state)
    rec["steps"] = k
    rec["samples"] = k * loop.channels * st["block"]
    rec["latencies_s"] = lat
    rec["handed_packets"] = (st["i"] - i0) * loop.channels * loop.packets
    rec["tx_packets"] = st["program_trace"].counters().get("tx.packets", 0) - packets0
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"], torch_.cuda.max_memory_allocated(ctx.device))
        rec["window_peak_bytes"] = torch_.cuda.max_memory_allocated(ctx.device) - st["staged_bytes"]
    if ctx.trace:
        rec["spans_ms"] = spans.mean_ms()
    spans.on = False
    st["kept"] = kept


def check(ctx, st) -> dict:
    """The sampled steps against the payloads handed in and, step by step,
    against the reference TX, channel and receiver (run after the
    program's state is freed)."""
    torch_, dev = ctx.torch, ctx.device
    loop = st["loop"]
    c, d, kb = loop.channels, loop.rx.config.max_detections, loop.packets
    fp, pt = loop.rx.front_pad, loop.rx.pad_tail()
    steps = {slot: (i, _rows(out, c, d), host, state) for slot, (i, out, host, state) in st["kept"].items()}
    noise = loop.noise
    tx_cfg = ctx.config["tx"]
    del st["kept"], st["loop"], st["step"], loop
    if dev.type == "cuda":
        torch_.cuda.empty_cache()
    totals = {"missed": 0, "false": 0, "dup": 0, "expected": 0, "tx_diff": 0.0, "channel_diff": 0.0,
              "det_diff": 0, "row_diff": 0, "esn0_gap_db": 0.0,
              "tx_packets_gap": abs(ctx.record["tx_packets"] - ctx.record["handed_packets"])}
    dtype = getattr(torch, ctx.hooks.get("reference_dtype", "float32"))
    ref_tx = ReferenceTransmitter(dev, int(tx_cfg.get("samples_per_symbol", 4)),
                                  int(tx_cfg.get("max_packets_glfsr", 4096)), dtype)
    ref_rx = ReferenceReceiver(ctx.config["rx"], dev)
    frames = {}
    pool, draws, bl = st["pool"], st["draws"], st["burst_len"]
    for slot, (i, rows, host, state) in sorted(steps.items()):
        s, pid = i % LINK_DRAWS, st["ids"][i % len(st["ids"])]
        offset = draws["offset"][s]
        truth = [[(fp + int(offset[ch]) + j * bl, int(pid[ch, j]), True) for j in range(kb)] for ch in range(c)]
        chan = host.row.numpy() // d
        packets = [(int(ch), int(idx), host.data[j, : int(host.length[j])].numpy())
                   for j, (ch, idx) in enumerate(zip(chan, host.index.numpy()))]
        m = correct.match_truth(packets, truth, pool)
        for key in ("missed", "false", "dup", "expected"):
            totals[key] += m[key]
        for p in np.unique(pid):
            if p not in frames:
                frames[p] = ReferenceTransmitter.data_symbols(pool[p])
        want = ref_tx.bank([[frames[p] for p in row] for row in pid], np.full(c, i * kb), offset, st["block"])
        prog_tx = st["tx_buf"][slot]
        totals["tx_diff"] = max(totals["tx_diff"], float((prog_tx - want).abs().max()))
        del want
        want = channel(prog_tx, draws["cfo"][s], draws["phase"][s], noise, state, fp, pt, dtype)
        totals["channel_diff"] = max(totals["channel_diff"], float((st["rx_buf"][slot] - want).abs().max()))
        del want
        r = correct.compare_rows(rows, ref_rx.decode(st["rx_buf"][slot]))
        totals["det_diff"] += r["det_diff"]
        totals["row_diff"] += r["row_diff"]
        totals["esn0_gap_db"] = max(totals["esn0_gap_db"], r["esn0_gap_db"])
    return totals
