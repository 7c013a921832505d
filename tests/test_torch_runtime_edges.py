"""The port's host edges against the JAX package: flow control and rate
probing (``runtime/flow.py``), the message blocks (``runtime/messages.py``),
raw complex64 file IO (``io/file.py``) and the native TUN/ring library
(``io/tun.py``, built from ``native/tunio.cpp`` into
``build/native/libpmtun.so``).

The cases of tests/test_runtime.py ``TestFlow``, ``TestMessages`` and
``TestHostIo`` run on the port's modules; the copies also behave as the
originals on the same inputs (the file blocks equal the JAX function's,
the ring moves the same bytes).
"""

import ctypes
import os
import time

import numpy as np
import pytest

pytest.importorskip("torch")

from gr4_packet_modem_tpu.io import file as jfile  # noqa: E402
from gr4_packet_modem_tpu.runtime import flow as jflow  # noqa: E402
from gr4_packet_modem_tpu.runtime import messages as jmessages  # noqa: E402
from gr4_packet_modem_tpu_torch.io import file as pfile  # noqa: E402
from gr4_packet_modem_tpu_torch.io import tun  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.flow import (  # noqa: E402
    PacketCredit, ProbeRate, RateReport, Throttle,
)
from gr4_packet_modem_tpu_torch.runtime.messages import (  # noqa: E402
    ItemStrobe, MessageDebug, MessageDebugStream, MessageStrobe, PacketStrobe,
)


# ------------------------------------------------------------------ flow


def test_throttle():
    th = Throttle(100000.0)
    t0 = time.monotonic()
    for _ in range(5):
        th.wait(2000)
    assert time.monotonic() - t0 >= 0.08


def test_probe_rate():
    pr = ProbeRate()
    assert pr.update(100) is None  # the first call only starts the clock
    time.sleep(0.25)
    rep = pr.update(100)
    assert isinstance(rep, RateReport)
    assert 100 < rep.rate_now < 10000
    assert rep.rate_avg == rep.rate_now  # the first report seeds the average
    assert pr.total == 200


def test_packet_credit():
    credit = PacketCredit(2)
    assert credit.acquire(0.01)
    assert credit.acquire(0.01)
    assert not credit.acquire(0.05)  # full
    credit.release()
    assert credit.acquire(0.01)
    assert credit.in_flight == 2


def test_flow_copy_matches_jax(monkeypatch):
    """On the same clock readings and calls, the copy's rate reports and
    credit counters are the original's."""
    reports = []
    for cls in (jflow.ProbeRate, ProbeRate):
        clock = iter([0.0, 0.1, 0.3, 0.7, 0.75, 1.2])
        monkeypatch.setattr(time, "monotonic", lambda: next(clock))
        pr = cls(alpha=0.5)
        reps = [pr.update(n) for n in (500, 100, 700, 900, 50, 400)]
        reports.append([r and (r.rate_now, r.rate_avg) for r in reps] + [pr.total])
    monkeypatch.undo()
    assert reports[0] == reports[1]
    assert sum(r is not None for r in reports[0][:-1]) == 3
    for cls in (jflow.PacketCredit, PacketCredit):
        c = cls(3)
        assert [c.acquire(0.01) for _ in range(4)] == [True, True, True, False]
        c.release(2)
        assert c.in_flight == 1


# -------------------------------------------------------------- messages


def test_item_strobe_pull():
    strobe = ItemStrobe(item=42, interval=0.02)
    t0 = time.monotonic()
    items = [strobe.next_item() for _ in range(3)]
    assert items == [42, 42, 42]
    # the first item fires at once, the next two wait one interval each
    # (0.9: time.sleep may undershoot by the timer granularity)
    assert time.monotonic() - t0 >= 0.9 * 2 * 0.02


def test_item_strobe_push():
    got = []
    strobe = ItemStrobe(item="x", interval=0.02, callback=got.append)
    strobe.start()
    time.sleep(0.1)
    strobe.stop()
    assert len(got) >= 2


def test_message_debug_stream():
    dbg = MessageDebugStream()
    dbg.push({"a": 1})
    assert dbg.drain(iter([{"b": 2}, {"c": 3}])) == 2
    assert dbg.messages() == [{"a": 1}, {"b": 2}, {"c": 3}]


def test_message_strobe_and_debug():
    """MessageStrobe delivers copies of its message to a MessageDebug, as
    the JAX package's do."""
    got = {}
    for name, strobe_cls, debug_cls in (
        ("port", MessageStrobe, MessageDebug),
        ("jax", jmessages.MessageStrobe, jmessages.MessageDebug),
    ):
        dbg = debug_cls()
        msg = {"k": 1}
        strobe = strobe_cls(dbg.store, msg, 0.02).start()
        time.sleep(0.12)
        strobe.stop()
        got[name] = dbg.messages()
        assert len(got[name]) >= 2 and all(m == msg and m is not msg for m in got[name])
    assert got["port"][0] == got["jax"][0]


def test_packet_strobe():
    strobe, jstrobe = PacketStrobe(16, 0.01), jmessages.PacketStrobe(16, 0.01)
    for _ in range(2):
        p, q = strobe.next_packet(), jstrobe.next_packet()
        assert p.dtype == q.dtype == np.uint8 and np.array_equal(p, q) and p.size == 16


# ---------------------------------------------------------------- host IO


def test_file_roundtrip(tmp_path):
    path = str(tmp_path / "x.c64")
    data = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    pfile.write_c64(path, data)
    np.testing.assert_array_equal(pfile.read_c64(path), data)
    np.testing.assert_array_equal(pfile.read_c64(path, 7), data[:7])
    blocks = list(pfile.stream_c64_blocks(path, 33))
    np.testing.assert_array_equal(np.concatenate(blocks), data)


@pytest.mark.parametrize("block", [1, 33, 100, 4096])
def test_stream_blocks_equal_jax(tmp_path, block):
    """``stream_c64_blocks`` yields the JAX function's blocks (sizes and
    samples), a file written through ``FileSinkC64`` in pieces included."""
    rng = np.random.default_rng(block)
    data = (rng.standard_normal(257) + 1j * rng.standard_normal(257)).astype(np.complex64)
    path = str(tmp_path / "s.c64")
    with pfile.FileSinkC64(path) as sink:
        sink.write(data[:100])
        sink.write(data[100:])
    mine = list(pfile.stream_c64_blocks(path, block))
    theirs = list(jfile.stream_c64_blocks(path, block))
    assert [b.size for b in mine] == [b.size for b in theirs]
    for a, b in zip(mine, theirs):
        assert a.dtype == b.dtype == np.complex64
        np.testing.assert_array_equal(a, b)


def test_native_ring():
    """``native_lib()`` builds ``build/native/libpmtun.so`` from the repo's
    ``native/tunio.cpp``; the SPSC ring round-trips, across its wrap."""
    lib = tun.native_lib()
    assert os.path.exists(tun._LIB_PATH)
    assert tun._LIB_PATH.parent.name == "native" and tun._LIB_PATH.parent.parent.name == "build"
    ring = lib.pm_ring_create(256)
    msg = b"x" * 100
    assert lib.pm_ring_write(ring, msg, len(msg)) == 100
    assert lib.pm_ring_readable(ring) == 100
    buf = ctypes.create_string_buffer(256)
    assert lib.pm_ring_read(ring, buf, 256) == 100
    assert buf.raw[:100] == msg
    # wrap-around
    big = bytes(range(200))
    assert lib.pm_ring_write(ring, big, len(big)) == 200
    m = lib.pm_ring_read(ring, buf, 256)
    assert buf.raw[:m] == big
    lib.pm_ring_destroy(ring)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A compiler that fails makes ``build_native`` raise with its output;
    nothing returns a quiet None."""
    monkeypatch.setattr(tun, "_LIB_PATH", tmp_path / "native" / "libpmtun.so")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="native IO build failed"):
        tun.build_native()
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot run"):
        tun.build_native()
