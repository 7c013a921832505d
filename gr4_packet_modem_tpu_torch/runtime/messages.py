"""Message-domain utilities (a copy of
``gr4_packet_modem_tpu/runtime/messages.py``: pure Python).

The reference's asynchronous control plane (gr::Message property-map messages
between blocks and to the scheduler — SURVEY §1 'Message domain') maps to
plain host-side Python in this framework. These helpers mirror the reference's
message/test-fixture blocks:

- ``MessageDebug`` (message_debug.hpp): print/store endpoints.
- ``MessageStrobe`` (message_strobe.hpp) / ``ItemStrobe`` (item_strobe.hpp) /
  ``PacketStrobe`` (packet_strobe.hpp): periodic stimulus sources used by QA
  and apps (timed idle-packet injection).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable

__all__ = [
    "MessageDebug",
    "MessageDebugStream",
    "MessageStrobe",
    "ItemStrobe",
    "PacketStrobe",
]


class MessageDebug:
    """Collect and/or print messages (property-map dicts)."""

    def __init__(self, do_print: bool = False):
        self._messages: list[dict] = []
        self._print = do_print
        self._lock = threading.Lock()

    def store(self, message: dict) -> None:
        with self._lock:
            self._messages.append(message)
        if self._print:
            print(f"[message] {message}")

    def messages(self) -> list[dict]:
        with self._lock:
            return list(self._messages)


class MessageDebugStream:
    """Stream-input variant of MessageDebug (message_debug_stream.hpp):
    instead of named message endpoints it consumes an *iterable/stream* of
    messages — the framework analogue of ``PortIn<gr::Message>`` — storing
    and optionally printing each. ``drain(it)`` consumes a whole iterable;
    ``push(msg)`` consumes one item."""

    def __init__(self, do_print: bool = False):
        self._inner = MessageDebug(do_print)

    def push(self, message: dict) -> None:
        self._inner.store(message)

    def drain(self, messages) -> int:
        n = 0
        for m in messages:
            self._inner.store(m)
            n += 1
        return n

    def messages(self) -> list[dict]:
        return self._inner.messages()


class ItemStrobe:
    """Periodic single-*item* source (item_strobe.hpp): unlike
    MessageStrobe it emits a stream item (any value) per interval, pull- or
    push-driven. ``next_item()`` blocks until the next item is due and
    returns it; with a callback, ``start()`` pushes on a thread."""

    def __init__(self, item, interval: float, callback=None):
        self.item = item
        self.interval = float(interval)
        self._callback = callback
        self._next_due = time.monotonic()
        self._stop = threading.Event()
        self._thread = None

    def next_item(self):
        now = time.monotonic()
        delay = self._next_due - now
        if delay > 0:
            time.sleep(delay)
        self._next_due = max(self._next_due + self.interval, time.monotonic())
        return self.item

    def start(self):
        assert self._callback is not None, "start() needs a callback"
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self.interval):
            self._callback(self.item)

    def stop(self):
        self._stop.set()
        if self._thread is not None and self._thread.is_alive():
            self._thread.join(timeout=2 * self.interval + 1)


class MessageStrobe:
    """Call ``callback(message)`` every ``interval`` seconds on a thread."""

    def __init__(
        self,
        callback: Callable[[dict], Any],
        message: dict,
        interval: float,
    ):
        self._callback = callback
        self._message = message
        self._interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(self._interval):
            self._callback(dict(self._message))

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2 * self._interval + 1)


class PacketStrobe:
    """Generate fixed-length zero packets at a fixed interval
    (packet_strobe.hpp). ``next_packet()`` blocks until the next is due."""

    def __init__(self, packet_length: int, interval: float):
        self.packet_length = packet_length
        self.interval = interval
        self._next_due = time.monotonic()

    def next_packet(self):
        import numpy as np

        now = time.monotonic()
        delay = self._next_due - now
        if delay > 0:
            time.sleep(delay)
        self._next_due = max(self._next_due + self.interval, time.monotonic())
        return np.zeros(self.packet_length, np.uint8)
