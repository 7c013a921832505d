"""Spans of the port's own work: where its host time and device time go.

Tracing is off by default. :func:`span` is a context manager placed where
the work happens: the receiver's stages (``rx.*``), the staging and
dispatch of ``StreamingBank`` (``stream.*``), the bank forms of the
transmitter (``tx.step``, with ``.frame``, ``.shape`` and ``.layout``), the
transceiver bank's channel (``channel.impair``) and, in stream mode, its
slide of the receiver's bank (``rx.slide``) and the stream step's last
stage (``rx.hand_on``). While tracing is off it
returns one shared object that does nothing: no allocation, no profiler
annotation, no CUDA event, no clock read. While it is on, a span

- inside a ``torch.profiler`` session, opens
  ``torch.profiler.record_function("span:<name>")``, so that it lies on
  the session's timeline with the kernels it launched; the profiler names
  each kernel on the device's side by the innermost span that launched it
  (outside a session the annotation would go nowhere, and costs more than
  the rest of the span);
- reads the host's clock (``time.perf_counter_ns``) at its start and end;
- where ``device`` is a CUDA device, records a CUDA event pair on the
  current stream around its work;
- keeps a :class:`Record` (name, parent span, step id, host start and end,
  device ms) in a bounded ring, and adds to running totals per name:
  calls, host seconds, self host seconds (its duration less its
  children's) and device ms.

A span launches no device work and reads no device value, so the
program's outputs are the same with tracing on and off. An event pair's
time is read once its end event has completed (polled when later spans
close), and :func:`totals` waits for the rest.

    from gr4_packet_modem_tpu_torch.utils import trace

    trace.enable(True)
    rx.bank_step(x, 0)                # warm-up
    trace.reset()
    for x in banks:
        rx.bank_step(x, 0)
    for name, t in trace.totals()["spans"].items():
        print(name, t["calls"], t["host_s"], t["self_host_s"], t["device_ms"])

``next_step()`` advances the step id that every span of one bank step (or
one streamed block) carries; :meth:`Receiver.bank_step` and
``StreamingBank`` call it.

Counters (:func:`count`) are kept whether tracing is on or off: an integer
add a call. ``utils/graphs.py`` counts how each bank step ran
(``rx.graph.captured``, ``.replayed``, ``.eager``, ``.evicted``); the
receiver counts the work its shapes set: ``rx.extract.chunks`` (the
symbol extractions' chunks, each its own clamp of the region to the row),
``rx.extract.fused_rows`` (the rows each launch of the fused extraction
kernel extracted, ``ops/matched_cuda.py::extract_symbols``: on the card 2 x
D a bank step, both passes of every step), ``rx.costas.rows`` (the rows
handed to the Costas loop, ``ops/costas_cuda.py::costas_track``, on
either route: 2 x D a Costas bank step, D with the V&V carrier) and
``rx.payload.slot_symbols``
(rows times symbols the payload pass decoded); the transmitter's bank
forms count ``tx.samples`` (the bank samples they wrote) and the burst form
``tx.packets`` (the packets it framed), once a call; in stream mode the
transceiver bank counts ``tx.packets`` and ``tx.idle_packets`` (the packets,
and the IDLE packets among them, handed to a step, from the host's lengths
and types). The stream step's count of its decoded rows, and of the IDLE
ones among them, is added on the card (``Receiver.stream_rows``). A step replayed from
CUDA graphs adds what the eager step adds. :func:`counters` reads them,
and :func:`totals` returns them under ``"counters"``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass

import torch

__all__ = [
    "Record", "span", "enable", "enabled", "reset", "next_step", "count", "counters", "totals",
    "records",
]

RING = 1 << 16  # records kept (a 64-channel bank step makes about 20)


@dataclass(slots=True)
class Record:
    """One closed span. Host times are ``perf_counter_ns`` readings;
    ``device_ms`` is the time between its CUDA events (None for a host
    span, or until the end event has completed)."""

    name: str
    parent: str | None
    step: int
    start_ns: int
    end_ns: int
    device_ms: float | None = None


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_on = False
_step = 0
_ring: deque[Record] = deque(maxlen=RING)
# name -> [calls, host ns, self host ns, device ms, calls with device ms]
_totals: dict[str, list] = {}
_pending: deque = deque()  # (record, start event, end event) not read yet
_counters: dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()  # each thread's stack of open spans


class _Span:
    __slots__ = ("name", "cuda", "parent", "child_ns", "start", "rf", "events")

    def __init__(self, name: str, device):
        self.name = name
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.child_ns = 0
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function("span:" + self.name)
            self.rf.__enter__()
        if self.cuda:
            self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.cuda:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        rec = Record(self.name, parent.name if parent is not None else None, _step, self.start, end)
        with _lock:
            _ring.append(rec)
            t = _totals.setdefault(self.name, [0, 0, 0, 0.0, 0])
            t[0] += 1
            t[1] += dur
            t[2] += dur - self.child_ns
            if self.cuda:
                _pending.append((rec, *self.events))
                _resolve(wait=False)
        return False


def _resolve(wait: bool) -> None:
    """Read the event pairs whose end has completed, oldest first; with
    ``wait``, wait for each (the caller holds ``_lock``)."""
    while _pending:
        rec, a, b = _pending[0]
        if wait:
            b.synchronize()
        elif not b.query():
            return
        rec.device_ms = a.elapsed_time(b)
        t = _totals.get(rec.name)
        if t is not None:
            t[3] += rec.device_ms
            t[4] += 1
        _pending.popleft()


def span(name: str, device: torch.device | None = None):
    """A span named ``name`` around a ``with`` block. ``device``: the
    device the block's work runs on; a CUDA device adds an event pair, so
    that the span has a device time."""
    if not _on:
        return _OFF
    return _Span(name, device)


def enable(on: bool = True) -> None:
    """Switch tracing on or off."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    """Whether tracing is on."""
    return _on


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (tracing on or off)."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    """The counters since the last :func:`reset` (no wait for any span)."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    """Forget every record, total and counter, and start the step ids
    again at 0."""
    global _step
    with _lock:
        _ring.clear()
        _totals.clear()
        _pending.clear()
        _counters.clear()
        _step = 0


def next_step() -> int:
    """Advance the step id (while tracing is on) and return it."""
    global _step
    if _on:
        _step += 1
    return _step


def totals() -> dict:
    """The running totals since the last :func:`reset`, after waiting for
    every span's end event: ``{"steps": step id, "spans": {name:
    {"calls", "host_s", "self_host_s", "device_ms", "device_calls"}},
    "counters": {name: count}}``. ``device_ms`` sums the event times of
    ``device_calls`` calls (None for a host span)."""
    with _lock:
        _resolve(wait=True)
        spans = {
            name: {"calls": c, "host_s": h / 1e9, "self_host_s": s / 1e9,
                   "device_ms": d if dc else None, "device_calls": dc}
            for name, (c, h, s, d, dc) in _totals.items()
        }
        return {"steps": _step, "spans": spans, "counters": dict(_counters)}


def records() -> list[Record]:
    """The ring's records, oldest first."""
    with _lock:
        return list(_ring)
