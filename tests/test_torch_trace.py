"""The port's spans (``gr4_packet_modem_tpu_torch/utils/trace.py``) on the
CPU: nothing while tracing is off, the span tree of ``bank_step`` with its
parents, step ids and self times while it is on, the same outputs either
way, ``StreamingBank``'s staging split, and the reduction of a
profiler session with nested spans (``scripts/trace_rx_torch.py``, and
the benchmark's own ``h100_bench.trace.reduce``, whose numbers the
program's spans must leave as they are)."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(max_payload_len=128, max_detections=8, freq_bins=1)
STAGES = ("rx.acquire", "rx.headers", "rx.suppress", "rx.payload")
SUBSPANS = {
    "rx.acquire": ("rx.acquire.correlate", "rx.acquire.peaks", "rx.acquire.estimate"),
    "rx.headers": ("rx.headers.extract", "rx.headers.costas", "rx.headers.ldpc"),
    "rx.payload": ("rx.payload.extract", "rx.payload.carrier", "rx.payload.crc"),
}
PARENT = {**{s: "rx.step" for s in STAGES}, **{c: p for p, cs in SUBSPANS.items() for c in cs},
          "rx.payload.extract.chunk": "rx.payload.extract"}


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off and nothing recorded."""
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


def _payloads():
    rng = np.random.default_rng(4)
    return [rng.integers(0, 256, n, dtype=np.uint8) for n in (60, 128, 9)]


def _bank(rx, channels=4):
    """Three bursts a channel, channel c rotated by 0.3 c rad and 50 c
    samples later (tests/test_torch_cuda.py's bank)."""
    burst = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(_payloads())])
    fp = rx.front_pad
    x = torch.zeros(channels, fp + 16384 + rx.pad_tail(), dtype=torch.complex64)
    for c in range(channels):
        rot = (np.exp(0.3j * c) * burst).astype(np.complex64)
        x[c, fp + 50 * c : fp + 50 * c + burst.size] = torch.from_numpy(rot)
    return x


@pytest.fixture(scope="module")
def vv():
    rx = Receiver(RxConfig(**CFG, payload_carrier="vv"), "cpu")
    return rx, _bank(rx)


def _profiled_names(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def test_off_leaves_no_span_and_no_record(vv):
    rx, x = vv
    names = _profiled_names(lambda: rx.bank_step(x, 2))
    assert not [n for n in names if n.startswith("span:")]
    # the counters are kept with tracing off: one eager step of two groups,
    # each a one-chunk header and payload extraction over 2 x 8 rows of
    # 4 (128 + 4) payload symbols, and the header pass's Costas loop over
    # those rows (the V&V payload carrier runs none)
    counters = {"rx.graph.eager": 1, "rx.extract.chunks": 4, "rx.payload.slot_symbols": 4 * 8 * 528,
                "rx.costas.rows": 2 * 2 * 8}
    assert trace.records() == [] and trace.totals() == {"steps": 0, "spans": {}, "counters": counters}
    assert trace.span("rx.step") is trace.span("rx.payload", torch.device("cpu"))  # one shared no-op


def test_bank_step_span_tree(vv):
    """Two steps, the first in two channel groups: one ``rx.step`` each,
    every stage once a group under it and every sub-span once under its
    stage, one step id a step; each span's self time is its time less its
    children's, so the self times of a step's tree add up to the step."""
    rx, x = vv
    trace.enable(True)
    names = _profiled_names(lambda: (rx.bank_step(x, 2), rx.bank_step(x, 0)))
    assert {"span:" + n for n in PARENT} | {"span:rx.step"} <= names
    recs = trace.records()
    tot = trace.totals()
    assert tot["steps"] == 2
    for step, groups in ((1, 2), (2, 1)):
        mine = [r for r in recs if r.step == step]
        count = {n: sum(r.name == n for r in mine) for n in {r.name for r in mine}}
        assert count == {"rx.step": 1, **{n: groups for n in PARENT}}, count
        root = next(r for r in mine if r.name == "rx.step")
        assert root.parent is None
        for r in mine:
            if r.name != "rx.step":
                assert r.parent == PARENT[r.name], (r.name, r.parent)
                assert root.start_ns <= r.start_ns <= r.end_ns <= root.end_ns
            assert r.device_ms is None  # no CUDA event on the CPU
    spans = tot["spans"]
    assert {n: t["calls"] for n, t in spans.items()} == {"rx.step": 2, **{n: 3 for n in PARENT}}
    assert sum(t["self_host_s"] for t in spans.values()) == pytest.approx(spans["rx.step"]["host_s"], rel=1e-9)
    for stage, subs in SUBSPANS.items():
        kids = sum(spans[s]["host_s"] for s in subs)
        assert spans[stage]["self_host_s"] == pytest.approx(spans[stage]["host_s"] - kids, rel=1e-9, abs=1e-12)
    assert all(t["device_ms"] is None and t["device_calls"] == 0 for t in spans.values())
    trace.reset()
    assert trace.records() == [] and trace.totals() == {"steps": 0, "spans": {}, "counters": {}}


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_outputs_equal_with_tracing_on_and_off(carrier, vv):
    rx, x = vv if carrier == "vv" else (None, None)
    if rx is None:
        rx = Receiver(RxConfig(**CFG, payload_carrier=carrier), "cpu")
        x = _bank(rx, channels=2)
    outs = []
    for on in (False, True):
        trace.enable(on)
        outs.append(rx.bank_step(x, 0))
    trace.enable(False)
    (d0, h0, r0, k0), (d1, h1, r1, k1) = outs
    assert int(r0.accepted.sum()) == 3 * x.shape[0]
    for a, b in ((d0, d1), (h0, h1), (r0, r1)):
        for f in vars(a):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(k0, k1)
    assert trace.totals()["spans"]["rx.step"]["calls"] == 1


def test_streaming_bank_split_and_spans():
    """The staging split adds up within ``h2d_s``; with tracing on, every
    block is one step with its staging, copy, dispatch (the receiver's
    stages under it) and, two blocks behind, its materialisation."""
    burst = np.concatenate([burst_samples(p, packet_index=i) for i, p in enumerate(_payloads())])
    x = np.zeros((2, 3 * 4096), np.complex64)
    x[0, 100 : 100 + burst.size] = burst
    x[1, 900 : 900 + burst.size] = burst * np.exp(0.4j)
    bank = StreamingBank(RxConfig(**CFG), "cpu", channels=2, block=4096, group=0)
    trace.enable(True)
    got = bank.process(x) + bank.flush()
    trace.enable(False)
    assert len(got) == 6
    st = bank.stats
    assert st["stage_s"] > 0 and st["slot_wait_s"] >= 0
    assert st["stage_s"] + st["slot_wait_s"] <= st["h2d_s"]
    tot = trace.totals()
    assert tot["steps"] == st["blocks"]
    calls = {n: t["calls"] for n, t in tot["spans"].items()}
    for n in ("stream.h2d", "stream.dispatch", "stream.materialize", "rx.acquire", "rx.suppress", "rx.payload"):
        assert calls[n] == st["blocks"], (n, calls)
    assert calls["stream.stage"] >= st["blocks"] and "stream.slot_wait" not in calls  # no events on the CPU
    parents = {(r.name, r.parent) for r in trace.records()}
    assert {("rx.acquire", "stream.dispatch"), ("rx.suppress", "stream.dispatch")} <= parents


def test_ring_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "_ring", trace.deque(maxlen=3))
    trace.enable(True)
    for i in range(5):
        trace.next_step()
        with trace.span("outer"):
            with trace.span("inner"):
                pass
    recs = trace.records()
    assert [(r.name, r.step) for r in recs] == [("outer", 4), ("inner", 5), ("outer", 5)]
    assert trace.totals()["spans"]["inner"]["calls"] == 5


# ------------------------------------------------- a made-up profiler session

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


def _ev(name, start, end, device=CUDA, annotation=False):
    tr = SimpleNamespace(start=start, end=end, elapsed_us=lambda: end - start)
    return SimpleNamespace(name=name, device_type=device, time_range=tr, is_user_annotation=annotation)


def _session(program_spans: bool):
    """Three steps of 100 us. The host: ``rx.step`` over 2-95, the
    harness's wrapper ``acquire`` over 3-40 around ``rx.acquire`` over
    4-39, ``rx.suppress`` over 48-80; the device: a kernel in acquire at
    10-30, a copy in suppression at 60-70. Without program spans the same
    session holds only the harness's."""
    evs = []
    for k in range(3):
        t = 100 * k
        evs += [_ev("span:step", t, t + 100, CPU), _ev("span:acquire", t + 3, t + 40, CPU),
                _ev("span:acquire", t + 10, t + 30, CUDA, True), _ev("k1", t + 10, t + 30),
                _ev("copy", t + 60, t + 70)]
        if program_spans:
            evs += [_ev("span:rx.step", t + 2, t + 95, CPU), _ev("span:rx.acquire", t + 4, t + 39, CPU),
                    _ev("span:rx.suppress", t + 48, t + 80, CPU),
                    _ev("span:rx.step", t + 10, t + 70, CUDA, True),
                    _ev("span:rx.acquire", t + 10, t + 30, CUDA, True),
                    _ev("span:rx.suppress", t + 60, t + 70, CUDA, True)]
    return SimpleNamespace(events=lambda: evs)


def _script():
    spec = importlib.util.spec_from_file_location("trace_rx_torch", ROOT / "scripts" / "trace_rx_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_session_gaps_named_by_innermost_span():
    """The gaps of steps 2 and 3 (the window runs from the second step's
    start), each named by the span with the most of its own time in it:
    100-110 ``rx.acquire`` (6 us against the step's 2 and the wrappers'
    1), 130-160 ``rx.suppress`` (12 us against ``rx.step``'s 8 alone),
    170-210 ``rx.step`` (15 us against ``rx.suppress``'s 10 and the
    step's 5), 230-260 and 270-300 the same. Idle while the host is in
    ``rx.step``: 8 + 30 + 33 + 30 + 25 of the 200 us window."""
    s = _script().session_spans(torch, _session(True), 3)
    assert s["whole"] and s["ops_per_step"] == 2
    assert [g for g, _ in s["gaps"]] == ["rx.step", "rx.suppress", "rx.suppress", "rx.step", "rx.acquire"]
    assert [t for _, t in s["gaps"]] == pytest.approx([40e-6, 30e-6, 30e-6, 30e-6, 10e-6])
    assert s["idle_pct"] == pytest.approx(70.0)
    assert s["dispatch_idle_pct"] == pytest.approx(63.0)
    assert s["idle_pct_by_span"] == pytest.approx({"rx.step": 35.0, "rx.suppress": 30.0, "rx.acquire": 5.0})
    assert s["gpu_spans"]["rx.suppress"] == {"kernel_ms": pytest.approx(10e-3), "ops": 1}
    assert s["gpu_spans"]["rx.step"] == {"kernel_ms": pytest.approx(30e-3), "ops": 2}
    assert _script().session_spans(torch, SimpleNamespace(events=lambda: []), 3) is None


def test_innermost_names_nested_and_outside():
    names = _script().innermost_names(
        [(0, 100, "step"), (10, 90, "rx.step"), (20, 40, "rx.acquire"), (22, 38, "rx.acquire.peaks")],
        [(0, 5), (19, 23), (25, 35), (41, 60), (95, 99), (100, 120)])
    assert names == ["step", "rx.acquire", "rx.acquire.peaks", "rx.step", "step", "outside spans"]


def test_program_spans_leave_the_benchmark_readers_unchanged():
    """The benchmark's own reduction of the same session with and
    without the program's spans: the same busy and window time, device
    operations, kernel time and the wrapper's span kernel time (what
    ``launches_per_step.rx``, ``idle_pct.rx``, ``acquire_roofline_pct.rx``
    and ``k4_roofline_pct.rx`` read); with them, no gap is named ``step``
    where a program span was open."""
    from h100_bench import trace as bench_trace

    a = bench_trace.reduce(torch, _session(False), 3)
    b = bench_trace.reduce(torch, _session(True), 3)
    for key in ("whole", "ops", "ops_per_step", "busy_s", "window_s", "kernel_s", "device_ops"):
        assert a[key] == b[key], key
    assert a["span_kernel_s"]["acquire"] == b["span_kernel_s"]["acquire"]
    assert "step" in {n for n, _ in a["idle_gaps"]} and "step" not in {n for n, _ in b["idle_gaps"]}


def test_span_table_sums_descendants():
    """The script's table: per step from the window's totals, device
    kernel time and operations of a span with its descendants' and its own."""
    tot = {"steps": 2, "spans": {
        "rx.step": {"calls": 2, "host_s": 0.02, "self_host_s": 0.002, "device_ms": 30.0, "device_calls": 2},
        "rx.acquire": {"calls": 2, "host_s": 0.01, "self_host_s": 0.001, "device_ms": 12.0, "device_calls": 2},
        "rx.acquire.peaks": {"calls": 2, "host_s": 0.009, "self_host_s": 0.009, "device_ms": None,
                             "device_calls": 0}}}
    parents = {"rx.step": None, "rx.acquire": "rx.step", "rx.acquire.peaks": "rx.acquire"}
    session = {"gpu_spans": {"rx.step": {"kernel_ms": 0.5, "ops": 3}, "rx.acquire.peaks": {"kernel_ms": 2.0, "ops": 54}}}
    t = _script().span_table(tot, parents, session)
    assert t["rx.step"] == {"calls": 1, "host_ms": 10.0, "self_host_ms": 1.0, "event_ms": 15.0, "kernel_ms": 2.5,
                            "ops": 57, "own_kernel_ms": 0.5, "own_ops": 3}
    assert (t["rx.acquire"]["kernel_ms"], t["rx.acquire"]["own_ops"]) == (2.0, None)
    assert t["rx.acquire.peaks"]["event_ms"] is None
    assert _script().span_table(tot, parents, None)["rx.step"]["kernel_ms"] is None
