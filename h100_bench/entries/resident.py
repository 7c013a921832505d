"""Resident entry: ``Receiver.bank_step`` over channel banks already on the
card, each step ending with its packets on the host.

Set-up stages the mix's ``blocks`` distinct banks (each ``[channels,
front_pad + block + pad_tail]`` complex64, the block's samples between the
receiver's zero pads) and runs ``WARM_PASSES`` steps on each. The window cycles
through them. A step is what a user of ``bank_step`` needs: the bank
decoded, then the accepted rows' bytes, lengths, CRC flags, Es/N0,
indices and rows copied to the host. Its latency runs from the call to
the packets on the host; ``rx_sps`` counts the block's samples of every
channel of every step completed in the window.

After the window, the steps of a sample drawn from the seed (and the first
step of each bank and the last step) are checked: their packets against
the transmitted ones, and their stages' rows against the plain reference
receiver on the same bank.
"""

from __future__ import annotations

import time

import numpy as np

from h100_bench import correct, traffic, work
from h100_bench.reference.receiver import ReferenceReceiver
from h100_bench.trace import Spans, profile_steps

PROFILED_STEPS = 5
# warm-up passes over the banks: a window's first ~50 steps ran 10-25 %
# slower than its rest on the H100 when set-up warmed each bank once
WARM_PASSES = 12
SAMPLED_STEPS = 12


def setup(ctx):
    torch, dev = ctx.torch, ctx.device
    from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig

    cfg, mix = ctx.config, ctx.mix
    rx = Receiver(RxConfig(**cfg["rx"]), dev)
    ctx.mark("receiver")
    block, c = int(cfg["block"]), int(mix["channels"])
    fp, pt = rx.front_pad, rx.pad_tail()
    pool = traffic.make_pool(ctx.seed, mix, dev)
    rng = traffic.rng_for(ctx.seed, 2)
    gen = traffic.torch_generator(ctx.seed, dev)
    banks, truths = [], []
    for _ in range(int(mix["blocks"])):
        lay = traffic.make_layout(rng, c, block, pool, float(mix["cfo"]))
        x = torch.zeros(c, fp + block + pt, dtype=torch.complex64, device=dev)
        x[:, fp : fp + block] = traffic.synthesize(lay, pool, block, float(mix["noise"]), gen)
        banks.append(x)
        truths.append([[(fp + s, p, w) for s, p, w in row] for row in traffic.truth(lay, pool, block)])
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

    for _ in range(WARM_PASSES):  # every shape of the window, and the host's pace
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
    ctx.record["work"] = {"acquire_least_s": work.least_s(nbytes, ops), "k4_least_s": work.least_s(k4, 0)}
    return {"rx": rx, "banks": banks, "truths": truths, "pool": pool, "step": step, "spans": spans,
            "staged_bytes": sum(x.numel() * x.element_size() for x in banks), "block": block}


def window(ctx, st, seconds: float) -> None:
    torch, rec = ctx.torch, ctx.record
    banks, step, spans = st["banks"], st["step"], st["spans"]
    rng = traffic.rng_for(ctx.seed, 3)
    sample = set(rng.choice(np.arange(len(banks), 64 * len(banks)), SAMPLED_STEPS, replace=False).tolist())
    sample.update(range(len(banks)))
    kept = {}
    lat = []
    spans.on = ctx.trace
    profile_at = seconds / 3 if ctx.trace else float("inf")
    k = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t - t0 >= profile_at:
            profile_at = float("inf")
            i = k % len(banks)

            def one():
                nonlocal i
                step(banks[i % len(banks)])
                i += 1

            rec["profile"], ran = profile_steps(torch, one, PROFILED_STEPS)
            k += ran  # profiled steps count as work of the window, not as latencies
            continue
        out, host = step(banks[k % len(banks)])
        lat.append(time.perf_counter() - t)
        if k in sample:
            kept[k] = (out, host)
        k += 1
        if time.perf_counter() >= t_end and k >= len(banks):  # every bank's first step is checked
            break
    rec["window_s"] = time.perf_counter() - t0
    kept[k - 1] = (out, host)
    rec["steps"] = k
    rec["samples"] = k * len(banks[0]) * st["block"]
    rec["latencies_s"] = lat
    if ctx.device.type == "cuda":
        rec["memory_peak_bytes"] = max(rec["setup_peak_bytes"], torch.cuda.max_memory_allocated(ctx.device))
        rec["window_peak_bytes"] = torch.cuda.max_memory_allocated(ctx.device) - st["staged_bytes"]
    if ctx.trace:
        rec["spans_ms"] = spans.mean_ms()
    spans.on = False
    st["kept"] = kept


def _rows(out, c: int, d: int) -> dict:
    det, hdr, res, keep = out
    t = {"index": det.index, "valid": det.valid, "esn0_db": det.esn0_db, "header_ok": hdr.header_ok,
         "length": hdr.packet_length, "packet_type": hdr.packet_type, "keep": keep,
         "crc_ok": res.crc_ok, "accepted": res.accepted}
    rows = {k: v.cpu().numpy().reshape(c, d) for k, v in t.items()}
    rows["data"] = res.data.cpu().numpy().reshape(c, d, -1)
    return rows


def check(ctx, st) -> dict:
    """The sampled steps against the transmitted packets and, bank by bank,
    against the reference (run after the program's state is freed)."""
    torch = ctx.torch
    rx, banks, kept = st["rx"], st["banks"], st["kept"]
    c, d = len(banks[0]), rx.config.max_detections
    n = len(banks)
    prog = {k: (k % n, _rows(out, c, d), host) for k, (out, host) in kept.items()}
    del st["kept"], kept, st["rx"], st["step"], rx
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    totals = {"missed": 0, "false": 0, "dup": 0, "expected": 0, "det_diff": 0, "row_diff": 0,
              "esn0_gap_db": 0.0}
    payloads = st["pool"].payloads
    for k, (b, rows, host) in sorted(prog.items()):
        chan = host["row"].numpy() // d
        packets = [(int(ch), int(i), host["data"][j, : int(host["length"][j])].numpy())
                   for j, (ch, i) in enumerate(zip(chan, host["index"].numpy()))]
        m = correct.match_truth(packets, st["truths"][b], payloads)
        for key in ("missed", "false", "dup", "expected"):
            totals[key] += m[key]
    ref = ReferenceReceiver(ctx.config["rx"], ctx.device)
    for b in sorted({b for b, _, _ in prog.values()}):
        want = ref.decode(banks[b])
        for _, rows, _ in (v for v in prog.values() if v[0] == b):
            r = correct.compare_rows(rows, want)
            totals["det_diff"] += r["det_diff"]
            totals["row_diff"] += r["row_diff"]
            totals["esn0_gap_db"] = max(totals["esn0_gap_db"], r["esn0_gap_db"])
    return totals
