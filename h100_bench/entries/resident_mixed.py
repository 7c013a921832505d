"""Resident entry for a mix of packet lengths: ``Receiver.bank_step`` over
channel banks already on the card, as ``entries/resident.py``, whose
window and check it runs, with packets of many lengths back to back.

The mix's keys, beside ``entry``, ``channels``, ``blocks`` and ``noise``
(as ``traffic.py`` has them):

- ``lengths``: the packet lengths in bytes of one run. Each channel carries
  runs back to back, each run a permutation of the lengths drawn from the
  seed, so every seed lays the same sizes;
- ``pool``: distinct random payloads for each entry of ``lengths``; a
  packet takes one of its entry's, drawn from the seed;
- ``cfo_set``: each channel's carrier offset in rad/sample is one of
  these, drawn from the seed; its phase is uniform.

A channel's runs start at an offset drawn uniformly over one run. The
bursts come from the frozen stimulus (``reference/stimulus.py``); the
samples are laid out, rotated and noised on the device with a generator
seeded from the seed.

Set-up records the least time of acquire, of the Costas loop's header and
payload chains and of the step's symbol extractions (``extract_work.py``).
After the window, where the program counts ``rx.payload.slot_symbols``
(read as a difference around the window; every step decodes the same
slots), the payload pass's fill: the symbols that the accepted packets of
the checked steps carry, ``4 (length + 4)`` each, over the slot-symbols
the program decoded in those steps.
"""

from dataclasses import dataclass

import numpy as np
import torch

from h100_bench import extract_work, traffic, work
from h100_bench.entries import resident
from h100_bench.reference import stimulus
from h100_bench.trace import Spans


@dataclass
class MixedPool:
    payloads: list          # uint8 arrays; pool id = entry of lengths * pool + variant
    burst_len: np.ndarray   # int [P] samples of each pool id's burst
    bursts: torch.Tensor    # complex64 [P, longest burst] on the device, zero past each burst


def make_pool(seed: int, mix: dict, device: torch.device) -> MixedPool:
    """``pool`` random payloads for each entry of ``lengths`` and their
    bursts (packet index = pool id, which picks the ramp-down bits)."""
    rng = traffic.rng_for(seed, 1)
    per = int(mix["pool"])
    payloads = [rng.integers(0, 256, int(n), dtype=np.uint8) for n in mix["lengths"] for _ in range(per)]
    bursts = [stimulus.burst_samples(p, i) for i, p in enumerate(payloads)]
    burst_len = np.array([b.size for b in bursts])
    padded = np.zeros((len(bursts), burst_len.max()), np.complex64)
    for i, b in enumerate(bursts):
        padded[i, : b.size] = b
    return MixedPool(payloads, burst_len, torch.from_numpy(padded).to(device))


@dataclass
class MixedLayout:
    """Packet ``k`` of channel ``c`` is pool id ``order[c, k]`` and starts at
    ``starts[c, k]`` (packet 0 at or before the span's start)."""

    order: np.ndarray   # int [C, K]
    starts: np.ndarray  # int [C, K]
    cfo: np.ndarray     # float64 [C] rad/sample
    phase: np.ndarray   # float64 [C]


def make_layout(rng: np.random.Generator, channels: int, span: int, pool: MixedPool, mix: dict) -> MixedLayout:
    n, per = len(mix["lengths"]), int(mix["pool"])
    run = int(pool.burst_len[::per].sum())  # an entry's variants share its length
    runs = -(-span // run) + 2
    perm = np.stack([np.concatenate([rng.permutation(n) for _ in range(runs)]) for _ in range(channels)])
    order = perm * per + rng.integers(0, per, perm.shape)
    ends = np.cumsum(pool.burst_len[order], axis=1)
    starts = ends - pool.burst_len[order] - rng.integers(0, run, channels)[:, None]
    cfo = rng.choice(np.asarray(mix["cfo_set"], np.float64), channels)
    phase = rng.uniform(-np.pi, np.pi, channels)
    return MixedLayout(order, starts, cfo, phase)


def synthesize(lay: MixedLayout, pool: MixedPool, span: int, noise: float, gen: torch.Generator) -> torch.Tensor:
    """The channels' samples ``[C, span]`` complex64 on the pool's device:
    each sample taken from the burst that covers it, each channel rotated
    by its CFO and phase, plus complex Gaussian noise of ``noise`` a
    component."""
    dev = pool.bursts.device
    c = lay.order.shape[0]
    starts = torch.from_numpy(lay.starts).to(dev)
    t = torch.arange(span, device=dev)
    k = torch.searchsorted(starts, t.expand(c, span).contiguous(), right=True) - 1
    pid = torch.from_numpy(lay.order).to(dev).gather(1, k)
    x = pool.bursts[pid, t[None, :] - starts.gather(1, k)]
    del k, pid
    ang = (torch.from_numpy(lay.cfo).to(dev)[:, None] * t[None, :].double()
           + torch.from_numpy(lay.phase).to(dev)[:, None])
    x = x * torch.polar(torch.ones_like(ang), ang).to(torch.complex64)
    del ang
    z = torch.randn(c, span, 2, generator=gen, device=dev) * noise
    return x + torch.view_as_complex(z)


def truth(lay: MixedLayout, pool: MixedPool, span: int) -> list[list[tuple[int, int, bool]]]:
    """Per channel, the ``(start, pool id, whole)`` of every packet whose
    burst overlaps ``[0, span)``, as ``traffic.truth``."""
    out = []
    for starts, order in zip(lay.starts, lay.order):
        bl = pool.burst_len[order]
        out.append([(int(s), int(p), bool(0 <= s and s + b <= span))
                    for s, p, b in zip(starts, order, bl) if -b < s < span])
    return out


def _slot_symbols() -> int | None:
    """The program's ``rx.payload.slot_symbols`` counter, or None where
    the program has no such counter."""
    from gr4_packet_modem_tpu_torch.utils import trace

    return trace.totals()["counters"].get("rx.payload.slot_symbols")


def setup(ctx):
    dev = ctx.device
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    cfg, mix = ctx.config, ctx.mix
    rx = Receiver(RxConfig(**cfg["rx"]), dev)
    ctx.mark("receiver")
    block, c = int(cfg["block"]), int(mix["channels"])
    fp, pt = rx.front_pad, rx.pad_tail()
    pool = make_pool(ctx.seed, mix, dev)
    rng = traffic.rng_for(ctx.seed, 2)
    gen = traffic.torch_generator(ctx.seed, dev)
    banks, truths = [], []
    for _ in range(int(mix["blocks"])):
        lay = make_layout(rng, c, block, pool, mix)
        x = torch.zeros(c, fp + block + pt, dtype=torch.complex64, device=dev)
        x[:, fp : fp + block] = synthesize(lay, pool, block, float(mix["noise"]), gen)
        banks.append(x)
        truths.append([[(fp + s, p, w) for s, p, w in row] for row in truth(lay, pool, block)])
    ctx.mark("traffic")
    spans = Spans(torch, on=False)
    if ctx.trace:  # a run that reads no per-layer metric runs the program unwrapped
        spans.wrap(rx.acquirer, "acquire", "acquire")
        spans.wrap(rx, "decode_headers", "headers")
        spans.wrap(rx, "decode_payloads", "payload")
    group = int(cfg.get("group", 0))

    def step(x):
        out = rx.bank_step(x, group)
        if "fault" in ctx.hooks:
            out = ctx.hooks["fault"](out)
        det, hdr, res, keep = out
        with spans.region("to_host"):
            rows = res.accepted.nonzero().squeeze(1)
            host = {
                "row": rows.cpu(), "index": det.index[rows].cpu(), "length": res.lengths[rows].cpu(),
                "crc_ok": res.crc_ok[rows].cpu(), "esn0": det.esn0_db[rows].cpu(),
                "data": res.data[rows].cpu(),
            }
        return out, host

    for _ in range(int(ctx.hooks.get("warm_passes", resident.WARM_PASSES))):
        for x in banks:
            step(x)
    if dev.type == "cuda":
        ctx.record["setup_peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    acq = rx.acquirer
    rows = c * rx.config.max_detections
    nbytes, ops = work.acquire_work(c, banks[0].shape[1], acq.config.fft_size, acq.sync_len,
                                    acq.num_bins, rx.config.max_detections)
    k4 = work.costas_bytes(rows, 192)
    if rx.config.payload_carrier == "costas":
        k4 += work.costas_bytes(rows, rx.config.max_payload_syms)
    extract = extract_work.step_extraction_bytes(rows, cfg["rx"], rx.arm_len)
    ctx.record["work"] = {"acquire_least_s": work.least_s(nbytes, ops), "k4_least_s": work.least_s(k4, 0),
                          "extract_least_s": work.least_s(extract, 0)}
    return {"rx": rx, "banks": banks, "truths": truths, "pool": pool, "step": step, "spans": spans,
            "staged_bytes": sum(x.numel() * x.element_size() for x in banks), "block": block}


def window(ctx, st, seconds: float) -> None:
    before = _slot_symbols()
    resident.window(ctx, st, seconds)
    after = _slot_symbols()
    if before is not None and after is not None:
        st["slot_symbols_per_step"] = (after - before) / ctx.record["steps"]


def check(ctx, st) -> dict:
    per_step = st.pop("slot_symbols_per_step", None)
    if per_step:
        carried = sum(int((4 * (host["length"] + 4)).sum()) for _, host in st["kept"].values())
        ctx.record["payload_fill_pct"] = 100.0 * carried / (per_step * len(st["kept"]))
    return resident.check(ctx, st)
