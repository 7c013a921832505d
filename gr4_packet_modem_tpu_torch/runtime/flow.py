"""Host-side flow control and observability (a copy of
``gr4_packet_modem_tpu/runtime/flow.py``: pure Python).

Equivalents of the reference's scheduler-level flow blocks, reimplemented as
runtime services around the compiled device pipeline:

- ``Throttle``: wall-clock rate limiting (throttle.hpp:91-102) applied to
  sample blocks leaving the TX or entering the RX.
- ``ProbeRate``: exponential moving average of sample rate with periodic
  reporting (probe_rate.hpp:35-70) — the benchmark metric source.
- ``PacketCredit``: the latency-management credit loop. The reference bounds
  in-flight packets by messaging the packet count from the end of the TX
  chain back to TunSource, which blocks when entry-exit >= max_packets
  (tun_source.hpp:69-78, packet_counter.hpp). Here the same bound is one
  counter pair around the host->device->host pipeline.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

__all__ = ["Throttle", "ProbeRate", "RateReport", "PacketCredit"]


class Throttle:
    """Limit item throughput to ``rate`` items/s."""

    def __init__(self, rate: float):
        self.rate = float(rate)
        self._start = None
        self._items = 0

    def wait(self, num_items: int) -> None:
        """Block until ``num_items`` more items are allowed through."""
        now = time.monotonic()
        if self._start is None:
            self._start = now
        self._items += num_items
        due = self._start + self._items / self.rate
        delay = due - now
        if delay > 0:
            time.sleep(delay)


@dataclass
class RateReport:
    rate_now: float
    rate_avg: float


class ProbeRate:
    """Track item rate; ``update(n)`` per block, ``report()`` for the EMA."""

    def __init__(self, alpha: float = 0.15):
        self.alpha = alpha
        self._last_t = None
        self._rate_avg = None
        self._count = 0
        self._total = 0

    def update(self, num_items: int) -> RateReport | None:
        now = time.monotonic()
        self._total += num_items
        if self._last_t is None:
            self._last_t = now
            self._count = 0
            return None
        self._count += num_items
        dt = now - self._last_t
        if dt < 0.2:
            return None
        rate_now = self._count / dt
        self._count = 0
        self._last_t = now
        if self._rate_avg is None:
            self._rate_avg = rate_now
        else:
            self._rate_avg += self.alpha * (rate_now - self._rate_avg)
        return RateReport(rate_now=rate_now, rate_avg=self._rate_avg)

    @property
    def total(self) -> int:
        return self._total


class PacketCredit:
    """Bound the number of in-flight packets between ingress and an exit
    point (the reference's max_packets latency management)."""

    def __init__(self, max_packets: int = 2):
        self.max_packets = max_packets
        self._entry = 0
        self._exit = 0
        self._cv = threading.Condition()

    def acquire(self, timeout: float | None = None) -> bool:
        """Block until a packet may enter (entry - exit < max)."""
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._entry - self._exit < self.max_packets, timeout
            )
            if ok:
                self._entry += 1
            return ok

    def release(self, count: int = 1) -> None:
        """Record ``count`` packets leaving the pipeline."""
        with self._cv:
            self._exit += count
            self._cv.notify_all()

    @property
    def in_flight(self) -> int:
        with self._cv:
            return self._entry - self._exit
