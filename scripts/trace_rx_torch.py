#!/usr/bin/env python3
"""The receiver's own spans (``gr4_packet_modem_tpu_torch/utils/trace.py``)
on one benchmark cell, on the card.

Sets a cell up as ``python3 -m h100_bench`` does (its configuration,
traffic and entry module, from ``h100_bench/``), then:

1. **cost**: the entry's step in turns with the program's tracing off and
   on (no profiler), ``--seconds`` a turn, off-on-on-off-off-on: channel-
   samples a second of each turn;
2. **totals**: a window of ``--seconds`` with tracing on, then
   ``trace.totals()``: each span's calls, host ms and self host ms a step,
   and the device ms between its CUDA events;
3. **session**: ``--steps`` + 1 steps under ``torch.profiler`` with tracing
   off and then on (up to four sessions each, until one keeps a whole
   number of steps' device operations): the device operations a step
   with and without the spans, each span's device kernel ms and
   operations a step (from its GPU-side annotation), the idle gaps named
   by the innermost span open on the host, and the share of the window in
   which the device idles while the host is inside ``rx.step``.

With tracing off the bank step replays its stages from CUDA graphs
(``utils/graphs.py``); with it on, every step runs eagerly. So the turns
compare the graphed step with the traced eager one, and the session with
tracing off is the graphed timeline: there the step and its four stages
carry profiler annotations of their own (``span:rx.step``,
``span:rx.acquire``, ``span:rx.headers``, ``span:rx.suppress``,
``span:rx.payload``, host only, as the benchmark's ``--trace 1`` wrappers
are), which the graphs leave in place. The receiver's graph counters
(``Receiver.graph_counts()``) are printed after each phase.

A host-fed cell (``--workload vv8_stream``, staged in ``h100_bench``)
instead feeds blocks with tracing off and on, and reports ``StreamingBank``'s
``stats`` split a block (staging, the wait for a staging slot, the rest
of ``h2d_s``) and the ``stream.*`` spans.

    python3 scripts/trace_rx_torch.py --workload vv64_dense [--seed 7] [--seconds 8] [--steps 5]

Prints a table to standard error and one JSON line to standard output.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host-fed cells the benchmark stages but does not list: (config, traffic)
STAGED = {"vv8_stream": ("rx_vv", "stream_int8_8ch")}


# ------------------------------------------------------- a profiler session

def _annotation(e) -> bool:
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(("span:", "nccl:"))


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(ivs, s, e) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for a, b in ivs)


def innermost_names(host_spans, gaps):
    """Each gap ``(s, e)`` named by the host span that overlaps it most
    with its own time, the time of the spans nested inside it taken off,
    so that a gap inside ``rx.suppress`` is named ``rx.suppress`` and not
    ``rx.step`` or the harness's ``step`` around it; ``outside spans``
    where no span overlaps it. ``host_spans``: ``(start, end, name)``."""
    spans = sorted(host_spans, key=lambda t: (t[0], -t[1]))
    inner = []  # the union of each span's descendants
    for i, (s, e, _) in enumerate(spans):
        inner.append(_union([(a, b) for a, b, _ in spans[i + 1:] if a >= s and b <= e and a < e]))
    names = []
    for gs, ge in gaps:
        best, name = 0.0, "outside spans"
        for (s, e, n), kids in zip(spans, inner):
            if s >= ge:
                break
            if e <= gs:
                continue
            own = max(0.0, min(ge, e) - max(gs, s)) - _overlap(kids, gs, ge)
            if own > best:
                best, name = own, n
        names.append(name)
    return names


def session_spans(torch, prof, steps: int) -> dict | None:
    """The program's spans in one profiler session of ``steps`` steps, each
    step in a host span ``span:step`` (times in the profiler's us). The
    window runs from the second step's start to the last device operation
    or step end, as ``h100_bench.trace.reduce`` takes it. ``host_ms``: each
    host span's ms a step, over the whole session."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    dev = [e for e in evs if e.device_type == cuda]
    ops = [e for e in dev if not _annotation(e)]
    host = [(e.time_range.start, e.time_range.end, e.name[5:]) for e in evs
            if e.device_type != cuda and e.name.startswith("span:")]
    steps_host = sorted((s, e) for s, e, n in host if n == "step")
    if not ops or len(steps_host) < 2:
        return None
    w0 = steps_host[1][0]
    w1 = max([steps_host[-1][1]] + [o.time_range.end for o in ops])
    busy = _union((max(o.time_range.start, w0), min(o.time_range.end, w1)) for o in ops
                  if o.time_range.end > w0)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    names = innermost_names(host, gaps)
    host_ms = defaultdict(float)
    for s, e, n in host:
        host_ms[n] += (e - s) / 1e3 / steps
    idle_by = defaultdict(float)
    for (s, e), n in zip(gaps, names):
        idle_by[n] += e - s
    in_step = _union((s, e) for s, e, n in host if n == "rx.step")
    dispatch_idle = sum(_overlap(in_step, s, e) for s, e in gaps)
    gpu = defaultdict(list)
    for e in dev:
        if e.name.startswith("span:"):
            gpu[e.name[5:]].append((e.time_range.start, e.time_range.end))
    per = {}
    for n, ivs in gpu.items():
        if n == "step":
            continue
        inside = [o for o in ops if any(s <= o.time_range.start < e for s, e in ivs)]
        per[n] = {"kernel_ms": sum(o.time_range.elapsed_us() for o in inside) / 1e3 / steps,
                  "ops": len(inside) / steps}
    window = w1 - w0
    return {
        "whole": len(ops) % steps == 0, "ops_per_step": len(ops) / steps,
        "idle_pct": 100.0 * sum(e - s for s, e in gaps) / window,
        "dispatch_idle_pct": 100.0 * dispatch_idle / window,
        "idle_pct_by_span": {n: 100.0 * t / window for n, t in sorted(idle_by.items(), key=lambda kv: -kv[1])},
        "gaps": [[n, (e - s) / 1e6] for (s, e), n in sorted(zip(gaps, names), key=lambda g: g[0][0] - g[0][1])[:10]],
        "gpu_spans": per,
        "host_ms": dict(host_ms),
    }


# ------------------------------------------------------------------- cells

def load_cell(torch, name: str, seed: int, dev):
    """``(entry module, ctx, state)`` of cell ``name`` set up as the
    benchmark sets it up (a run without ``--trace``: no wrappers)."""
    from h100_bench import run

    manifest = json.loads(open(os.path.join(ROOT, "BENCHMARK.json")).read())
    cell = next((w for w in manifest["workloads"] if w["name"] == name), None)
    config, traffic = (cell["config"], cell["traffic"]) if cell else STAGED[name]
    bench = run.HERE
    cfg = json.loads((bench / "configs" / f"{config}.json").read_text())
    mix = json.loads((bench / "traffic" / f"{traffic}.json").read_text())
    entry = run.load_module(bench / "entries" / f"{mix['entry']}.py")
    ctx = run.Ctx(torch, dev, seed, False, cfg, mix, time.perf_counter())
    return entry, ctx, entry.setup(ctx)


def span_table(tot: dict, parents: dict, session: dict | None) -> dict:
    """Per span: calls, host ms and self host ms a step (from the traced
    window's totals), device ms a step between its events, and kernel ms
    and operations a step from the profiled session: its own (the
    profiler puts a kernel in the innermost span that launched it) and
    with its descendants' (``parents``: each span's parent)."""
    steps = max(tot["steps"], 1)
    gpu = (session or {}).get("gpu_spans", {})

    def under(n):  # n and its descendants
        return [m for m in tot["spans"] if m == n or n in _ancestors(m, parents)]

    def dev(n, key):
        if not gpu:
            return None
        return sum(gpu.get(m, {}).get(key, 0.0) for m in under(n))

    return {n: {"calls": t["calls"] / steps, "host_ms": 1e3 * t["host_s"] / steps,
                "self_host_ms": 1e3 * t["self_host_s"] / steps,
                "event_ms": t["device_ms"] / steps if t["device_ms"] is not None else None,
                "kernel_ms": dev(n, "kernel_ms"), "ops": dev(n, "ops"),
                "own_kernel_ms": gpu.get(n, {}).get("kernel_ms"), "own_ops": gpu.get(n, {}).get("ops")}
            for n, t in tot["spans"].items()}


def _ancestors(n, parents):
    while (n := parents.get(n)) is not None:
        yield n


# the receiver's step and stages, annotated in the graphed session:
# (attribute of the receiver holding the method, or None, method, span name)
ANNOTATED = ((None, "bank_step", "rx.step"), ("acquirer", "acquire", "rx.acquire"),
             (None, "decode_headers", "rx.headers"), (None, "filter_detections", "rx.suppress"),
             (None, "decode_payloads", "rx.payload"))


@contextmanager
def annotated(torch, rx):
    """Profiler annotations ``span:<name>`` around the receiver's step and
    stages (:data:`ANNOTATED`), set on the instances as the benchmark's
    wrappers are: host only, no events and no program spans, so the step
    still replays its graphs. Restores what the instances held before."""
    missing = object()
    saved = []
    for owner, method, name in ANNOTATED:
        obj = getattr(rx, owner) if owner else rx
        fn = getattr(obj, method)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            with torch.profiler.record_function("span:" + _name):
                return _fn(*a, **kw)

        saved.append((obj, method, obj.__dict__.get(method, missing)))
        setattr(obj, method, wrapped)
    try:
        yield
    finally:
        for obj, method, old in reversed(saved):
            if old is missing:
                delattr(obj, method)
            else:
                setattr(obj, method, old)


def resident(torch, st, args, trace, echo) -> dict:
    from h100_bench.trace import reduce

    banks, step, rx = st["banks"], st["step"], st["rx"]
    counts = {"setup": rx.graph_counts()}
    echo(f"graph counts after set-up: {counts['setup']}")
    per_step = len(banks[0]) * st["block"]
    k = [0]
    calls = []  # host seconds of each bank_step call: its dispatch
    bank_step = rx.bank_step

    def timed_bank_step(*a, **kw):
        t = time.perf_counter()
        out = bank_step(*a, **kw)
        calls.append(time.perf_counter() - t)
        return out

    rx.bank_step = timed_bank_step

    def one():
        step(banks[k[0] % len(banks)])
        k[0] += 1

    def turn(on: bool) -> dict:
        trace.enable(on)
        calls.clear()
        n, t0 = 0, time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            one()
            n += 1
        dt = time.perf_counter() - t0
        trace.enable(False)
        return {"tracing": on, "rx_sps": n * per_step / dt, "bank_step_host_ms": 1e3 * sum(calls) / len(calls)}

    turns = [turn(on) for on in (False, True, True, False, False, True)]
    counts["turns"] = rx.graph_counts()
    echo(f"graph counts after the turns: {counts['turns']}")
    trace.enable(True)
    trace.reset()
    turn(True)
    trace.enable(False)
    tot = trace.totals()
    parents = {r.name: r.parent for r in trace.records()}
    counts["traced_window"] = tot["counters"]
    echo(f"graph counters of the traced window (trace.totals): {tot['counters']}")

    def session(on: bool):
        best = None
        for _ in range(4):
            torch.cuda.synchronize()
            trace.enable(on)
            st["spans"].on = True  # the entry's own to_host annotation
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(args.steps + 1):
                    with torch.profiler.record_function("span:step"):
                        one()
                torch.cuda.synchronize()
            trace.enable(False)
            st["spans"].on = False
            r = reduce(torch, prof, args.steps + 1)
            s = session_spans(torch, prof, args.steps + 1)
            if r is not None and r["whole"] and s is not None:
                return r, s
            best = best or (r, s)
        return best

    before = rx.graph_counts()
    with annotated(torch, rx):
        r_off, s_off = session(False)
    counts["graphed_session"] = {k: v - before[k] for k, v in rx.graph_counts().items()}
    r_on, s_on = session(True)
    counts["end"] = rx.graph_counts()
    echo(f"graph counts of the graphed session: {counts['graphed_session']}; at the end: {counts['end']}")
    table = span_table(tot, parents, s_on)

    def mean(key, on):
        v = [t[key] for t in turns if t["tracing"] == on]
        return sum(v) / len(v)

    out = {
        "turns": turns,
        "rx_sps_off_mean": mean("rx_sps", False), "rx_sps_on_mean": mean("rx_sps", True),
        "on_over_off": mean("rx_sps", True) / mean("rx_sps", False),
        "bank_step_host_ms_off": mean("bank_step_host_ms", False),
        "bank_step_host_ms_on": mean("bank_step_host_ms", True),
        "ops_per_step_off": r_off and r_off["ops_per_step"], "ops_per_step_on": r_on and r_on["ops_per_step"],
        "whole": [bool(r_off and r_off["whole"]), bool(r_on and r_on["whole"])],
        "idle_pct_harness_rule": r_on and 100.0 * (1 - r_on["busy_s"] / r_on["window_s"]),
        "gaps_harness_rule": r_on and r_on["idle_gaps"],
        "suppress_ms": table.get("rx.suppress", {}).get("event_ms"),
        "step_host_ms": table.get("rx.step", {}).get("host_ms"),
        "session": s_on, "spans": table, "steps_traced": tot["steps"],
        "graph_counts": counts,
        "graphed": r_off and {
            "whole": r_off["whole"], "ops_per_step": r_off["ops_per_step"],
            "idle_pct_harness_rule": 100.0 * (1 - r_off["busy_s"] / r_off["window_s"]),
            "gaps_harness_rule": r_off["idle_gaps"], "session": s_off,
        },
    }
    echo(f"rx_sps off {out['rx_sps_off_mean']:.5g}, on {out['rx_sps_on_mean']:.5g} "
         f"(on/off {out['on_over_off']:.4f}); bank_step host ms off {out['bank_step_host_ms_off']:.3f}, "
         f"on {out['bank_step_host_ms_on']:.3f}; ops a step off {out['ops_per_step_off']}, "
         f"on {out['ops_per_step_on']}")
    echo("turns: " + ", ".join(f"{'on' if t['tracing'] else 'off'} {t['rx_sps']:.5g} "
                               f"({t['bank_step_host_ms']:.3f} ms)" for t in turns))
    if s_on:
        echo(f"idle {s_on['idle_pct']:.2f} %, of it while the host is in rx.step "
             f"{s_on['dispatch_idle_pct']:.2f} %; by innermost span: "
             + ", ".join(f"{n} {v:.2f}" for n, v in s_on["idle_pct_by_span"].items()))
    if s_off:
        echo(f"graphed (tracing off, a step from its graphs): idle {s_off['idle_pct']:.2f} %, of it while "
             f"the host is in rx.step {s_off['dispatch_idle_pct']:.2f} %; by innermost span: "
             + ", ".join(f"{n} {v:.2f}" for n, v in s_off["idle_pct_by_span"].items()))
        echo(f"{'graphed span':24s} {'host ms':>8s} {'kernel ms':>9s} {'ops':>7s}")
        for n, t in s_off["gpu_spans"].items():
            host = "-" if n not in s_off["host_ms"] else f"{s_off['host_ms'][n]:.3f}"
            echo(f"{n:24s} {host:>8s} {t['kernel_ms']:9.3f} {t['ops']:7.1f}")
    echo(f"{'span':24s} {'calls':>6s} {'host ms':>8s} {'self ms':>8s} {'event ms':>9s} "
         f"{'kernel ms':>9s} {'ops':>7s} {'own kern':>9s} {'own ops':>7s}")
    for n, t in table.items():
        cells = [t[c] for c in ("host_ms", "self_host_ms", "event_ms", "kernel_ms", "ops", "own_kernel_ms", "own_ops")]
        echo(f"{n:24s} {t['calls']:6.2f} " + " ".join("-" if v is None else f"{v:.3f}" for v in cells))
    return out


def stream(torch, entry, st, args, trace, echo) -> dict:
    bank = st["bank"]

    def turn(on: bool) -> dict:
        trace.enable(on)
        s0, t0 = dict(bank.stats), time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            entry.feed(st)
        dt = time.perf_counter() - t0
        trace.enable(False)
        s1 = dict(bank.stats)
        blocks = s1["blocks"] - s0["blocks"]
        ms = {k[:-2]: 1e3 * (s1[k] - s0[k]) / blocks for k in s1 if k.endswith("_s")}
        ms["copy_launch"] = ms["h2d"] - ms["stage"] - ms["slot_wait"]
        return {"tracing": on, "blocks": blocks, "stream_sps": blocks * bank.channels * st["block"] / dt,
                "ms_a_block": ms}

    turns = [turn(False)]
    trace.reset()
    turns.append(turn(True))
    tot = trace.totals()
    table = span_table(tot, {r.name: r.parent for r in trace.records()}, None)
    for t in turns:
        echo(f"tracing {t['tracing']}: {t['stream_sps']:.5g} samples/s, ms a block "
             + ", ".join(f"{k} {v:.3f}" for k, v in t["ms_a_block"].items()))
    for n, t in table.items():
        echo(f"  {n:22s} calls {t['calls']:.2f} host {t['host_ms']:.3f} self {t['self_host_ms']:.3f} ms a block")
    return {"turns": turns, "spans": table, "blocks_traced": tot["steps"]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**33 + 17)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from gr4_packet_modem_tpu_torch.utils import trace

    if not torch.cuda.is_available():
        raise SystemExit("trace_rx_torch: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]

    def echo(s):
        print(s, file=sys.stderr, flush=True)

    dev = torch.device("cuda")
    entry, ctx, st = load_cell(torch, args.workload, args.seed, dev)
    echo(f"{args.workload} on {card}, seed {args.seed}")
    body = (resident(torch, st, args, trace, echo) if "banks" in st
            else stream(torch, entry, st, args, trace, echo))
    out = {"workload": args.workload, "card": card, "seed": args.seed, "seconds": args.seconds, **body}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
