"""Host-fed entry: ``StreamingBank.process`` fed one block of host samples
at a time, in a closed loop (the next block when ``process`` returns), as
an SDR front end feeds a receiver.

Set-up builds one cycle of the mix's stream on the card (``blocks`` blocks
a channel, packets back to back and wrapping, quantised to the 8-bit
grid an SDR delivers) and brings it to host memory; the stream is that
cycle repeated. ``WARM_BLOCKS`` blocks warm the driver up. The window feeds whole
blocks for ``--seconds`` and then flushes the stream, so ``stream_sps``
covers every block fed in it and all the time it took. Latency is read
from the public entry alone: a block's runs from the call that hands it
over to the return of the call that hands back the last of the packets
whose syncword starts in it (the driver materialises a block's results
``pipeline_depth`` calls later, and a packet near a block's end needs
the next block's samples).

After the window every packet that lay wholly in the fed samples must
have come out exactly once with its bytes, with no block that saturated
the detection slots or the result wire (bench.py's parity gate); the
plain reference receiver decodes the cycle once, and the program's
packets are held against its packets.
"""

from __future__ import annotations

import time

import numpy as np

from h100_bench import correct, traffic
from h100_bench.reference.receiver import ReferenceReceiver
from h100_bench.trace import Spans, profile_steps

WARM_BLOCKS = 12  # a third of a second on the H100: the host's pace settles
# a packet this close to the stream's first sample has zeros in its noise
# window where the reference, which decodes the cycle with its own samples
# around it, has samples: its Es/N0 is compared from the next cycle on
HISTORY = 4096
PROFILED_BLOCKS = 8
WIRES = {"int8": lambda torch: torch.int8, "f32": lambda torch: None}


def make_cycle(seed: int, mix: dict, block: int, channels: int, dev):
    """One cycle of the stream, on the host: ``(samples [C, span]
    complex64, layout, pool)``."""
    span = block * int(mix["blocks"])
    pool = traffic.make_pool(seed, mix, dev)
    lay = traffic.make_layout(traffic.rng_for(seed, 2), channels, span, pool, float(mix["cfo"]),
                              circular=True)
    x = traffic.synthesize(lay, pool, span, float(mix["noise"]), traffic.torch_generator(seed, dev),
                           circular=True)
    return traffic.quantize(x, float(mix["adc_scale"])).cpu().numpy(), lay, pool


def budget(config: dict, block: int, burst_len: int) -> int:
    """bench.py's result budget a channel: packets that can start in a
    block + 4, at most the slots."""
    return min(int(config["rx"]["max_detections"]), -(-block // burst_len) + 4)


def instrument(ctx, bank, st: dict) -> None:
    """In a traced run, spans on the driver's staging, dispatch and
    materialisation, which name the host's work in the trace. They wrap
    private methods of the driver: a traced run whose driver lacks one
    fails, naming it. No end-to-end metric reads them."""
    spans = Spans(ctx.torch, on=False)
    if ctx.trace:
        spans.wrap(bank, "_stage_piece", "stage")
        spans.wrap(bank, "_step", "dispatch")
        spans.wrap(bank, "_materialize", "materialize")
    st.update(bank=bank, spans=spans, fed=0, packets=[], fed_at={}, out_at={})


def setup(ctx):
    torch, dev = ctx.torch, ctx.device
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank

    cfg, mix = ctx.config, ctx.mix
    block, c = int(cfg["block"]), int(mix["channels"])
    cycle, lay, pool = make_cycle(ctx.seed, mix, block, c, dev)
    ctx.mark("traffic")
    bank = StreamingBank(RxConfig(**cfg["rx"]), dev, channels=c, block=block,
                         transfer_dtype=WIRES[mix["transfer"]](torch), group=int(cfg.get("group", 0)),
                         result_budget=budget(cfg, block, pool.burst_len) * c)
    st = {"cycle": cycle, "lay": lay, "pool": pool, "block": block, "span": cycle.shape[1]}
    instrument(ctx, bank, st)
    if "fault" in ctx.hooks:
        ctx.hooks["fault"](bank)
    ctx.mark("driver")
    warm_up(ctx, st)
    return st


def warm_up(ctx, st) -> None:
    for _ in range(WARM_BLOCKS):
        feed(st)
    if ctx.device.type == "cuda":
        ctx.record["setup_peak_bytes"] = ctx.torch.cuda.max_memory_allocated(ctx.device)
        ctx.torch.cuda.reset_peak_memory_stats(ctx.device)


def keep(st, packets) -> None:
    """Keep each packet as a plain tuple ``(channel, index, esn0, bytes)``,
    which the garbage collector stops scanning; a run holds tens of
    thousands, and holding the driver's objects would slow its later
    blocks with collections a user who consumes them never pays."""
    st["packets"] += [(p.channel, p.index, p.esn0_db, p.data) for p in packets]


def returned(st, packets) -> None:
    """Keep the packets a call of the entry returned, and note the return
    as the latest time a packet of each block they start in reached the
    host."""
    t = time.perf_counter()
    block = st["block"]
    for b in {p.index // block for p in packets}:
        st["out_at"][b] = t
    keep(st, packets)


def feed(st) -> None:
    """Hand the stream's next block to the driver."""
    if "before_feed" in st:
        st["before_feed"]()
    b, block, span = st["fed"], st["block"], st["span"]
    lo = (b * block) % span
    st["fed_at"][b] = time.perf_counter()
    returned(st, st["bank"].process(st["cycle"][:, lo : lo + block]))
    st["fed"] = b + 1


def window(ctx, st, seconds: float) -> None:
    torch, rec, bank = ctx.torch, ctx.record, st["bank"]
    first = st["fed"]
    stats0 = dict(bank.stats)
    st["spans"].on = ctx.trace
    profile_at = seconds / 3 if ctx.trace else float("inf")
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while time.perf_counter() < t_end:
        if time.perf_counter() - t0 >= profile_at:
            profile_at = float("inf")
            rec["profile"], _ = profile_steps(torch, lambda: feed(st), PROFILED_BLOCKS)
            continue
        feed(st)
    stats1 = dict(bank.stats)
    if "before_flush" in st:
        st["before_flush"]()
    returned(st, bank.flush())  # the stream ends: every fed block's packets come back
    rec["window_s"] = time.perf_counter() - t0
    st["spans"].on = False
    last = st["fed"]
    blocks = last - first
    rec["blocks"] = blocks
    rec["samples"] = blocks * bank.channels * st["block"]
    out_at, fed_at = st["out_at"], st["fed_at"]
    rec["latencies_s"] = [out_at[b] - fed_at[b] for b in range(first, last) if b in out_at]
    rec["stats_ms"] = {k: 1e3 * (stats1[f"{k}_s"] - stats0[f"{k}_s"]) / max(blocks, 1)
                       for k in ("h2d", "dispatch", "materialize")}
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"], torch.cuda.max_memory_allocated(ctx.device))
        rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device)


def check(ctx, st) -> dict:
    """Parity over the whole fed stream (flushed at the window's end),
    then the packets against the reference's decode of the cycle."""
    torch, bank = ctx.torch, st["bank"]
    ovf = bank.overflow_blocks + bank.budget_overflow_blocks
    del st["bank"], bank
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    return compare(ctx, st, ovf)


def compare(ctx, st, ovf: int) -> dict:
    torch = ctx.torch
    pool, lay, span, block = st["pool"], st["lay"], st["span"], st["block"]
    fed = st["fed"] * block
    bl = pool.burst_len
    cyc = traffic.truth(lay, pool, span, circular=True)
    truth = [[(s + k * span, p, 0 <= s + k * span <= fed - bl) for k in range(-1, -(-fed // span) + 1)
              for s, p, _ in row if -bl < s + k * span < fed] for row in cyc]
    packets = [(c, i, data) for c, i, _, data in st["packets"]]
    numbers = correct.match_truth(packets, truth, pool.payloads)
    numbers["overflow_blocks"] = ovf
    # the reference decodes one cycle with the cycle's own samples around it
    margin = 8192
    x = np.concatenate([st["cycle"][:, span - margin :], st["cycle"], st["cycle"][:, : bl + margin]], 1)
    cfg = dict(ctx.config["rx"])
    cfg["max_detections"] = -(-x.shape[1] // bl) + 4
    ref = ReferenceReceiver(cfg, ctx.device)
    fp, pt = ref.front_pad, ref.pad_tail()
    xt = torch.zeros(x.shape[0], fp + x.shape[1] + pt, dtype=torch.complex64, device=ctx.device)
    xt[:, fp : fp + x.shape[1]] = torch.from_numpy(x).to(ctx.device)
    want = ref.decode(xt)
    got = {}
    for c in range(x.shape[0]):
        for j in np.nonzero(want["accepted"][c])[0]:
            pos = int(want["index"][c, j]) - fp - margin
            if 0 <= pos < span:
                n = int(want["length"][c, j])
                got[(c, pos)] = (want["data"][c, j, :n], float(want["esn0_db"][c, j]))
    seen, diff, gap = set(), 0, 0.0
    for c, index, esn0, data in st["packets"]:
        key = (c, index % span)
        if key not in got or not np.array_equal(got[key][0], data):
            diff += 1
            continue
        seen.add(key)
        if index >= HISTORY:
            gap = max(gap, abs(esn0 - got[key][1]))
    # reference packets the program never gave, though they lay whole in the fed samples
    for c, pos in got.keys() - seen:
        diff += any(abs((s % span) + correct.SYNC_DELAY - pos) <= correct.MATCH_TOL
                    for s, _, whole in truth[c] if whole)
    numbers.update(ref_diff=diff, esn0_gap_db=gap)
    return numbers
