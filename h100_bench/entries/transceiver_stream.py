"""Stream transceiver entry: upstream's packet transceiver in stream mode
(apps/packet_transceiver.cpp ``--stream``) on a bank of links, run through
the port's own ``TransceiverBank.stream_step`` (``models/transceiver.py``).
The carrier never stops: each link sends its packets back to back, IDLE
packets among them, and each step hands the program the packets that
start in the link's next ``block / sps`` symbols; packets cross every step
edge. The program transmits them after what it carried over, impairs them
into its sliding receiver bank and decodes the bank's fresh window with
the graphed stream step; it returns the accepted packets on the host. This
entry holds no transmitter or channel of its own.

The mix's keys, beside ``entry``, ``channels``, ``payload_len``, ``pool``,
``cfo`` and ``noise`` (as ``traffic.py`` has them):

- ``data``, ``idle``: each link sends back-to-back groups of ``data``
  user packets of ``payload_len`` bytes (from a seeded pool of ``pool``
  payloads) and ``idle`` IDLE packets of ``idle_len`` bytes, each group in
  a seeded order; an IDLE packet's bytes are the port's transceiver app's
  fill, ``(arange(idle_len) + seq) % 255`` for the link's ``seq``-th IDLE
  packet;
- ``groups``: the groups of one cycle of a link's schedule (its orders and
  payloads repeat after it); each link starts at a seeded packet of its
  cycle;
- ``packets``: the packets that may start in a link's step, the program's
  slots a step (set-up checks the schedule against it).

Each link's carrier offset (uniform in ``[-cfo, cfo]`` rad/sample) is
fixed for the run and its phase at the stream's start uniform; the noise
comes from the program's generator, seeded from the seed. Each step's
packets are staged from the pool into one set of pinned host buffers
before the step (the traffic source's work: in the window, outside the
step's latency). The loop is closed: a step starts when the last one's
packets are on the host. Its latency runs from handing the step's packets
to the program to its packets on the host; ``rx_sps`` counts the bank's
channel-samples (channels x block) of every step completed in the window.

Set-up runs ``WARM_STEPS`` steps, so that the receiver's graphs are
captured and every shape has run. Two runs of ``RUN_STEPS`` consecutive
steps are checked: the window's first, and one from a seeded step of its
first 64 (or, in a window shorter than that, its last). Before each
checked step the program's suppression state handed in is copied, after
it the TX block, the received bank and the state handed on, on the card
into buffers allocated at set-up (staged bytes, left out of
``peak_mem_gib``); and the generator's state before the step is kept.
After the window, with the program's state freed:

- each checked step's packets against the user packets whose syncword
  lies in its fresh window, in absolute stream positions (``missed``,
  ``false``, ``dup``; an IDLE packet delivered is ``false``);
- ``tx_diff``: the largest ``|program TX block -
  ReferenceStreamTransmitter's|``, the reference's from each link's
  packets counted from the stream's start;
- ``channel_diff``: the largest ``|program received bank - reference|``:
  the new block against the reference channel of the program's TX block
  (the phase from the stream's start, the same noise draws), and the
  look-back against the last step's bank where that step was checked
  too;
- ``det_diff``, ``row_diff``, ``esn0_gap_db``: the program's rows against
  ``ReferenceStreamReceiver`` on the program's received bank, seeded with
  the state the program was handed;
- ``carry_diff``: the links whose state handed on differs from the
  reference's, and, between consecutive checked steps, from the state the
  next step was handed;
- ``tx_packets_gap``: the program's counter ``tx.packets`` over the
  window against the packets handed to it.

In a ``--trace 1`` run, beside the spans of ``transceiver.py``: ``slide``
around the program's slide of its bank, and ``idle_rows_pct``, the IDLE
rows among the rows kept with a good header in the window, from the
program's own counts on the card (read around the window).

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
from h100_bench.reference.stream_receiver import ReferenceStreamReceiver
from h100_bench.reference.stream_transmitter import ReferenceStreamTransmitter, stream_channel
from h100_bench.trace import Spans, profile_steps

PROFILED_STEPS = 5
WARM_STEPS = 48
RUN_STEPS = 3
IDLE = 1  # PacketType.IDLE


class Schedule:
    """Every link's packets, from the stream's start: packet ``g`` of link
    ``c`` (``g >= 0``) is entry ``g % n`` of the link's cycle of ``n``
    packets, which starts at symbol ``(g // n) * cycle`` plus the entry's
    offset in the cycle. Methods take links ``c`` and packets ``g`` as
    arrays of one shape (or broadcast to one)."""

    def __init__(self, seed: int, mix: dict, channels: int, max_len: int):
        rng = traffic.rng_for(seed, 1)
        data, idle, groups = int(mix["data"]), int(mix["idle"]), int(mix["groups"])
        self.length, self.idle_len = int(mix["payload_len"]), int(mix["idle_len"])
        self.pool = rng.integers(0, 256, (int(mix["pool"]), self.length), dtype=np.uint8)
        npool = len(self.pool)
        # the payload table the steps are staged from: the pool, the 255
        # IDLE fills, a row of zeros for an empty slot
        self.table = np.zeros((npool + 256, max_len), np.uint8)
        self.table[:npool, : self.length] = self.pool
        self.table[npool : npool + 255, : self.idle_len] = (np.arange(self.idle_len)[None]
                                                            + np.arange(255)[:, None]) % 255
        self.empty = npool + 255
        self.table_t = torch.from_numpy(self.table)
        self.n = n = groups * (data + idle)
        kinds = np.stack([np.concatenate([rng.permutation([0] * data + [IDLE] * idle) for _ in range(groups)])
                          for _ in range(channels)])
        pid = rng.integers(0, npool, (channels, n))
        first = rng.integers(0, n, channels)  # each link starts at its own packet of the cycle
        take = (first[:, None] + np.arange(n)) % n
        self.kind = np.take_along_axis(kinds, take, 1)
        self.pid = np.take_along_axis(pid, take, 1)
        self.nbytes = np.where(self.kind == IDLE, self.idle_len, self.length)
        self.sizes = RC.SYNCWORD_LEN + 4 * (RC.HEADER_CODED_BYTES + self.nbytes + RC.CRC_NUM_BYTES)
        self.offset = np.cumsum(self.sizes, axis=1) - self.sizes  # [C, n] start in the cycle
        self.cycle = int(self.sizes[0].sum())  # every link's cycle holds the same packets
        self.idle_rank = np.cumsum(self.kind == IDLE, axis=1) - (self.kind == IDLE)
        self.idle_per_cycle = groups * idle

    def first_at(self, pos) -> np.ndarray:
        """Per link, the first packet that starts at or after symbol
        ``pos`` (an int or ``[C]``, >= 0)."""
        pos = np.broadcast_to(np.asarray(pos, np.int64), self.offset.shape[:1])
        q, r = np.divmod(pos, self.cycle)
        return q * self.n + (self.offset < r[:, None]).sum(1)

    def start(self, c, g) -> np.ndarray:
        """The start symbols of packets ``g`` of links ``c``."""
        return (g // self.n) * self.cycle + self.offset[c, g % self.n]

    def row(self, c, g) -> np.ndarray:
        """Rows of ``table`` that hold packets ``g`` of links ``c``: a pool
        entry, or the IDLE fill of the link's ``seq``-th IDLE packet."""
        e = g % self.n
        seq = (g // self.n) * self.idle_per_cycle + self.idle_rank[c, e]
        return np.where(self.kind[c, e] == IDLE, len(self.pool) + seq % 255, self.pid[c, e])

    def payload(self, row: int) -> np.ndarray:
        """The bytes of table row ``row`` (a pool entry or an IDLE fill)."""
        return self.table[row, : self.length if row < len(self.pool) else self.idle_len]

    def most_starts(self, span: int) -> int:
        """The most packets that start in any ``span`` symbols of a link."""
        most = 0
        for off in self.offset:
            ext = np.concatenate([off, off + self.cycle, off + 2 * self.cycle])
            most = max(most, int((np.searchsorted(ext, off + span) - np.arange(self.n)).max()))
        return most

    def fill(self, i: int, syms: int, slots: int, out: dict) -> int:
        """Stage step ``i``'s packets (those that start in each link's
        symbols ``[i * syms, (i + 1) * syms)``) into ``out``'s tensors
        ``data`` ``[C, slots, max_len]``, ``lengths`` and ``types`` ``[C,
        slots]`` (the bytes by one ``index_select`` from the table).
        Returns how many."""
        lo, hi = self.first_at(i * syms), self.first_at((i + 1) * syms)
        count = hi - lo
        if count.max() > slots:
            raise RuntimeError(f"step {i}: {count.max()} packets start in a link's step, over its {slots} slots")
        c = np.arange(len(lo))[:, None]
        g = lo[:, None] + np.arange(slots)
        sent = np.arange(slots) < count[:, None]
        e = g % self.n
        rows = torch.from_numpy(np.where(sent, self.row(c, g), self.empty).reshape(-1))
        data = out["data"]
        torch.index_select(self.table_t, 0, rows, out=data.view(-1, data.shape[-1]))
        out["lengths"].numpy()[...] = np.where(sent, self.nbytes[c, e], 0)
        out["types"].numpy()[...] = np.where(sent, self.kind[c, e], 0)
        return int(count.sum())

    def between(self, lo: int, hi: int) -> list[list[tuple[int, int, int]]]:
        """Per link, ``(start symbol, kind, table row)`` of the packets that
        start in symbols ``[lo, hi)`` (``lo >= 0``)."""
        a, b = self.first_at(lo), self.first_at(hi)
        out = []
        for c in range(len(a)):
            g = np.arange(a[c], b[c])
            out.append(list(zip(self.start(c, g).tolist(), self.kind[c, g % self.n].tolist(),
                                self.row(c, g).tolist())))
        return out


def setup(ctx):
    # the program's stream-mode bank loop; a program without it stops here
    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank
    from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig
    from gr4_packet_modem_tpu_torch.utils import trace as program_trace

    dev, cfg, mix = ctx.device, ctx.config, ctx.mix
    c, k, block = int(mix["channels"]), int(mix["packets"]), int(cfg["block"])
    sps = int(cfg["tx"].get("samples_per_symbol", 4))
    syms = block // sps
    loop = TransceiverBank(TxConfig(**cfg["tx"]), RxConfig(**cfg["rx"]), c, k, block, dev,
                           noise=float(mix["noise"]), group=int(cfg.get("group", 0)),
                           generator=traffic.torch_generator(ctx.seed, dev))
    if not hasattr(loop, "stream_step"):
        raise RuntimeError("the program's TransceiverBank has no stream mode")
    if "fault" in ctx.hooks:
        ctx.hooks["fault"](loop)
    ctx.mark("program")
    sched = Schedule(ctx.seed, mix, c, int(cfg["tx"]["max_payload_len"]))
    most = sched.most_starts(syms)
    if most > k:
        raise ValueError(f"up to {most} packets start in a link's step, over the mix's {k}")
    rng = traffic.rng_for(ctx.seed, 2)
    cfo = rng.uniform(-float(mix["cfo"]), float(mix["cfo"]), c)
    phase0 = rng.uniform(-np.pi, np.pi, c)
    loop.tune(torch.from_numpy(cfo), torch.from_numpy(phase0))
    pin = dev.type == "cuda"
    host = {"data": torch.zeros(c, k, int(cfg["tx"]["max_payload_len"]), dtype=torch.uint8, pin_memory=pin),
            "lengths": torch.zeros(c, k, dtype=torch.int64, pin_memory=pin),
            "types": torch.zeros(c, k, dtype=torch.int64, pin_memory=pin)}
    ctx.mark("traffic")

    spans = Spans(torch, on=False)
    if ctx.trace:  # a run that reads no per-layer metric runs the program unwrapped
        spans.wrap(loop.rx.acquirer, "acquire", "acquire")
        spans.wrap(loop.rx, "decode_headers", "headers")
        spans.wrap(loop.rx, "decode_payloads", "payload")
        spans.wrap(loop, "transmit", "tx")
        spans.wrap(loop, "impair", "channel")
        spans.wrap(loop, "slide", "slide")
        spans.wrap(loop, "to_host", "to_host")
    st = {"loop": loop, "sched": sched, "cfo": cfo, "phase0": phase0, "spans": spans, "block": block,
          "syms": syms, "i": 0, "handed": 0}

    def prepare():
        st["handed"] += sched.fill(st["i"], syms, k, host)

    def step():
        out = loop.stream_step(host["data"], host["lengths"], host["types"])
        st["i"] += 1
        return out

    def prepared_step():
        prepare()
        return step()

    st.update(prepare=prepare, step=step, prepared_step=prepared_step)
    for _ in range(int(ctx.hooks.get("warm_steps", WARM_STEPS))):
        prepared_step()
    # the check's copies: buffers of their own, counted as staged
    slots = 2 * RUN_STEPS
    st["tx_buf"] = torch.empty(slots, c, block, dtype=torch.complex64, device=dev)
    st["rx_buf"] = torch.empty(slots, *loop.bank.shape, dtype=torch.complex64, device=dev)
    st["busy_buf"] = torch.empty(slots, 2, c, dtype=torch.int64, device=dev)
    st["staged_bytes"] = sum(b.numel() * b.element_size() for b in (st["tx_buf"], st["rx_buf"], st["busy_buf"]))
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
    # the payload bytes of a step: a cycle's bytes over its symbols, a link's step of symbols
    step_bytes = c * syms * float(sched.nbytes[0].sum()) / sched.cycle
    ctx.record["work"] = {"acquire_least_s": work.least_s(nbytes, ops), "k4_least_s": work.least_s(k4, 0),
                          "tx_least_s": work.least_s(tx_work.tx_bytes(step_bytes, c, block), 0)}
    st["program_trace"] = program_trace
    return st


def _counts(st) -> tuple[dict, dict | None]:
    """The program's counters, and its stream row counts where it keeps
    them (one synchronising read)."""
    rx = st["loop"].rx
    rows = rx.stream_rows() if hasattr(rx, "stream_rows") else None
    return st["program_trace"].counters(), rows


def window(ctx, st, seconds: float) -> None:
    torch_, rec = ctx.torch, ctx.record
    loop, spans = st["loop"], st["spans"]
    rng = traffic.rng_for(ctx.seed, 3)
    runs = [0, int(rng.integers(RUN_STEPS, 64 - RUN_STEPS + 1))]
    kept = {}

    def run_slot(k: int) -> int | None:
        for r, start in enumerate(runs):
            if start <= k < start + RUN_STEPS:
                return r * RUN_STEPS + k - start
        return None

    lat = []
    counters0, rows0 = _counts(st)
    handed0, i0 = st["handed"], st["i"]
    spans.on = ctx.trace
    profile_at = seconds / 3 if ctx.trace else float("inf")
    k = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        slot = run_slot(k)
        t = time.perf_counter()
        if slot is None and k >= runs[1] + RUN_STEPS and t - t0 >= profile_at:
            profile_at = float("inf")
            rec["profile"], ran = profile_steps(torch_, st["prepared_step"], PROFILED_STEPS)
            k += ran  # profiled steps count as work of the window, not as latencies
            continue
        st["prepare"]()
        if slot is not None:
            st["busy_buf"][slot, 0].copy_(loop.busy)
            state = loop.generator.get_state()  # a host copy of its seed and offset
        t = time.perf_counter()
        out, host = st["step"]()
        lat.append(time.perf_counter() - t)
        if slot is not None:
            st["tx_buf"][slot].copy_(loop.tx_bank)
            st["rx_buf"][slot].copy_(loop.bank)
            st["busy_buf"][slot, 1].copy_(loop.busy)
            kept[slot] = (st["i"] - 1, out, host, state)
        k += 1
        if time.perf_counter() >= t_end and run_slot(k) is None:
            if k < runs[1]:  # a window too short for the seeded run: its last steps instead
                runs[1] = k
                continue
            break
    rec["window_s"] = time.perf_counter() - t0
    counters1, rows1 = _counts(st)
    rec["steps"] = k
    rec["samples"] = k * loop.channels * st["block"]
    rec["latencies_s"] = lat
    rec["handed_packets"] = st["handed"] - handed0
    rec["tx_packets"] = counters1.get("tx.packets", 0) - counters0.get("tx.packets", 0)
    slot_syms = [n.get("rx.payload.slot_symbols") for n in (counters0, counters1)]
    if None not in slot_syms:
        st["slot_symbols_per_step"] = (slot_syms[1] - slot_syms[0]) / (st["i"] - i0)
    if rows0 is not None and rows1["header_ok"] > rows0["header_ok"]:
        rec["idle_rows_pct"] = 100.0 * (rows1["idle"] - rows0["idle"]) / (rows1["header_ok"] - rows0["header_ok"])
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"], torch_.cuda.max_memory_allocated(ctx.device))
        rec["window_peak_bytes"] = torch_.cuda.max_memory_allocated(ctx.device) - st["staged_bytes"]
    if ctx.trace:
        rec["spans_ms"] = spans.mean_ms()
    spans.on = False
    st["kept"] = kept


def check(ctx, st) -> dict:
    """The checked steps against the packets handed in and, step by step,
    against the reference TX, channel and receiver (run after the
    program's state is freed)."""
    torch_, dev = ctx.torch, ctx.device
    loop = st["loop"]
    c, d = loop.channels, loop.rx.config.max_detections
    fp, pt, block, syms = loop.rx.front_pad, loop.rx.pad_tail(), st["block"], st["syms"]
    keep = fp + pt
    steps = {slot: (i, _rows(out, c, d), host, state) for slot, (i, out, host, state) in st["kept"].items()}
    noise = loop.noise
    per_step = st.pop("slot_symbols_per_step", None)
    del st["kept"], st["loop"], st["step"], st["prepare"], st["prepared_step"], loop
    if dev.type == "cuda":
        torch_.cuda.empty_cache()
    totals = {"missed": 0, "false": 0, "dup": 0, "expected": 0, "tx_diff": 0.0, "channel_diff": 0.0,
              "det_diff": 0, "row_diff": 0, "esn0_gap_db": 0.0, "carry_diff": 0,
              "tx_packets_gap": abs(ctx.record["tx_packets"] - ctx.record["handed_packets"])}
    dtype = getattr(torch, ctx.hooks.get("reference_dtype", "float32"))
    ref_tx = ReferenceStreamTransmitter(dev, int(ctx.config["tx"].get("samples_per_symbol", 4)), dtype)
    ref_rx = ReferenceStreamReceiver(ctx.config["rx"], dev, block)
    sched = st["sched"]
    sps = block // syms
    frames = {}

    def symbols(kind: int, row: int) -> np.ndarray:
        if row not in frames:
            frames[row] = ReferenceStreamTransmitter.packet_symbols(sched.payload(row), kind)
        return frames[row]

    carried = 0
    for slot, (i, rows, host, state) in sorted(steps.items()):
        # the user packets whose syncword lies in the step's fresh window
        lo = max(0, -(-(i * block - pt) // sps))
        hi = max(0, -(-((i + 1) * block - pt) // sps))
        truth = [[(sps * s - i * block + keep, row, True) for s, kind, row in link if kind != IDLE]
                 for link in sched.between(lo, hi)]
        chan = host.row.numpy() // d
        packets = [(int(ch), int(idx), host.data[j, : int(host.length[j])].numpy())
                   for j, (ch, idx) in enumerate(zip(chan, host.index.numpy()))]
        m = correct.match_truth(packets, truth, sched.table[:, : sched.length])
        for key in ("missed", "false", "dup", "expected"):
            totals[key] += m[key]
        carried += int((4 * (host.length + 4)).sum())
        # the TX block from every packet that overlaps the step's symbols
        links = sched.between(max(0, i * syms - ref_tx.history - int(sched.sizes.max())), (i + 1) * syms)
        want = ref_tx.block([[(s, symbols(kind, row)) for s, kind, row in link] for link in links], i, block)
        prog_tx = st["tx_buf"][slot]
        totals["tx_diff"] = max(totals["tx_diff"], float((prog_tx - want).abs().max()))
        del want
        want = stream_channel(prog_tx, st["cfo"], st["phase0"], i, noise, state, dtype)
        bank = st["rx_buf"][slot]
        totals["channel_diff"] = max(totals["channel_diff"], float((bank[:, keep:] - want).abs().max()))
        del want
        prev = steps.get(slot - 1)
        if slot % RUN_STEPS and prev is not None and prev[0] == i - 1:
            totals["channel_diff"] = max(totals["channel_diff"],
                                         float((bank[:, :keep] - st["rx_buf"][slot - 1][:, block:]).abs().max()))
            totals["carry_diff"] += int((st["busy_buf"][slot, 0] != st["busy_buf"][slot - 1, 1]).sum())
        ref = ref_rx.decode(bank, st["busy_buf"][slot, 0].cpu().numpy())
        totals["carry_diff"] += int((ref["busy_next"] != st["busy_buf"][slot, 1].cpu().numpy()).sum())
        r = correct.compare_rows(rows, ref)
        totals["det_diff"] += r["det_diff"]
        totals["row_diff"] += r["row_diff"]
        totals["esn0_gap_db"] = max(totals["esn0_gap_db"], r["esn0_gap_db"])
    if per_step:
        ctx.record["payload_fill_pct"] = 100.0 * carried / (per_step * len(steps))
    return totals
