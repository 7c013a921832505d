"""Spans and the device trace of a ``--trace 1`` run.

Spans: :class:`Spans` wraps methods of the program's objects (on the
instance, so the program is not edited) with CUDA events recorded on the
device timeline every call, and with a ``torch.profiler`` annotation
``span:<name>`` that names the host's work in the trace.

Trace: :func:`profile_steps` runs a few steps of the window under
``torch.profiler`` and :func:`reduce` turns the session into the device's
busy time, the device operations per step, the longest idle gaps named by
the span the host was in, and the device time of chosen kernels. The
profiler now and then drops records: a session counts as whole only when
it kept a whole number of steps' device operations (every step launches
the same); up to four sessions run, and where none is whole the readers
leave its numbers out.
"""

from __future__ import annotations

import contextlib
import functools
from collections import defaultdict


class Spans:
    """CUDA-event spans around methods, every call while ``on``."""

    def __init__(self, torch, on: bool):
        self.torch = torch
        self.on = on
        self.events: dict[str, list] = defaultdict(list)

    def wrap(self, obj, method: str, name: str) -> None:
        fn = getattr(obj, method, None)
        if not callable(fn):
            raise RuntimeError(f"h100_bench: the span {name!r} wraps {type(obj).__name__}.{method}, "
                               "which the program no longer has")
        torch = self.torch
        spans = self

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if not spans.on:
                return fn(*args, **kwargs)
            with torch.profiler.record_function(f"span:{name}"):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(*args, **kwargs)
                b.record()
            spans.events[name].append((a, b))
            return out

        setattr(obj, method, wrapped)

    def region(self, name: str):
        """A profiler annotation only (no events), for host regions."""
        if not self.on:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(f"span:{name}")

    def mean_ms(self) -> dict[str, float]:
        """Each span's mean device-timeline ms a call (after a synchronise)."""
        self.torch.cuda.synchronize()
        return {name: sum(a.elapsed_time(b) for a, b in ev) / len(ev)
                for name, ev in self.events.items() if ev}


def profile_steps(torch, step, steps: int, sessions: int = 4):
    """Run ``step()`` ``steps`` + 1 times under the profiler, each in a span
    ``span:step``, up to ``sessions`` times until one session is whole
    (:func:`reduce`). Returns ``(reduced, steps run)``: :func:`reduce` of
    the first whole session, else of the fullest with ``whole`` False, or
    None where no session kept a device record."""
    from torch.profiler import ProfilerActivity, profile

    best, ran = None, 0
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(steps + 1):
                with torch.profiler.record_function("span:step"):
                    step()
            torch.cuda.synchronize()
        ran += steps + 1
        r = reduce(torch, prof, steps + 1)
        if r is not None and r["whole"]:
            return r, ran
        if r is not None and (best is None or r["ops"] > best["ops"]):
            best = r
    return best, ran


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _annotation(e) -> bool:
    """A range on the device's timeline that names work (ours, ``span:``,
    or torch's own, such as ``nccl:all_gather``), not an operation."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith(("span:", "nccl:"))


def reduce(torch, prof, steps: int) -> dict | None:
    """The device's work in one profiler session of ``steps`` steps (the
    same work each). The session is whole when its device operations are
    a whole number of steps' worth. Counts and times a step are over all
    ``steps``; busy time and idle gaps are over the host's span from the
    second step on (the first carries the profiler's start), every device
    operation clipped to it."""
    cuda = torch.autograd.DeviceType.CUDA
    evs = list(prof.events())
    dev = [e for e in evs if e.device_type == cuda]
    ops = [e for e in dev if not _annotation(e)]
    host_spans = [(e.time_range.start, e.time_range.end, e.name[5:]) for e in evs
                  if e.device_type != cuda and e.name.startswith("span:")]
    steps_host = sorted((s, e) for s, e, n in host_spans if n == "step")
    if not ops or len(steps_host) < 2:
        return None
    gpu_spans = defaultdict(list)
    for e in dev:
        if e.name.startswith("span:"):
            gpu_spans[e.name[5:]].append((e.time_range.start, e.time_range.end))
    w0 = steps_host[1][0]
    w1 = max([steps_host[-1][1]] + [o.time_range.end for o in ops])
    busy = _union((max(o.time_range.start, w0), min(o.time_range.end, w1)) for o in ops
                  if o.time_range.end > w0)
    busy_us = sum(e - s for s, e in busy)
    # each idle gap is named by the host span that overlaps it most, the
    # step's own span counting only where no span inside it runs
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            over = defaultdict(float)
            for hs, he, n in host_spans:
                over[n] += max(0.0, min(e, he) - max(s, hs))
            over["step"] -= sum(v for n, v in over.items() if n != "step")
            name = max(over, key=over.get) if max(over.values(), default=0) > 0 else "outside spans"
            gaps.append((e - s, name))
    by_name = defaultdict(float)
    for o in ops:
        by_name[o.name] += o.time_range.elapsed_us()

    def inside(span: str) -> float:
        ivs = gpu_spans.get(span, [])
        return sum(o.time_range.elapsed_us() for o in ops
                   if any(s <= o.time_range.start < e for s, e in ivs))

    return {
        "whole": len(ops) % steps == 0, "steps": steps, "ops": len(ops),
        "ops_per_step": len(ops) / steps,
        "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
        "device_ops": [[n[:120], t / 1e6] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]],
        "idle_gaps": [[n, g / 1e6] for g, n in sorted(gaps, reverse=True)[:10]],
        "span_kernel_s": {s: inside(s) / 1e6 / steps for s in gpu_spans if s != "step"},
        "kernel_s": {n: t / 1e6 / steps for n, t in by_name.items()},
    }


def idle_pct(rec: dict) -> float | None:
    """Share of the traced window (the host's span of the profiled steps)
    in which no operation ran on the device, from a whole session."""
    prof = rec.get("profile")
    if not prof or not prof["whole"]:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def kernel_s(reduced: dict | None, part: str) -> float | None:
    """Device seconds a step of the kernels whose name holds ``part``, from
    a whole session (None otherwise, or where no such kernel ran)."""
    if not reduced or not reduced["whole"]:
        return None
    t = sum(v for n, v in reduced["kernel_s"].items() if part in n)
    return t or None
