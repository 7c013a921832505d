"""The bank step's CUDA graphs (``gr4_packet_modem_tpu_torch/utils/graphs.py``)
on the CPU, with the capture stubbed: keys, capture at second sight,
replays after it, the bounded least-recently-used chains, a chain dropped
when a stage meets other inputs, the launch counts, the counters, the
device a step's graphs run on, and the copies a step hands its caller.
``FakeGraphs`` stands in for the CUDA graph: a capture runs the stage once
and keeps its outputs, and a replay runs the stage again on the inputs it
was captured with and writes the results into those same outputs, as a
graph writes its static tensors.
The card's own graphs are held to the eager step in
``tests/test_torch_cuda.py``."""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig, flatten_detections  # noqa: E402
from gr4_packet_modem_tpu_torch.ops import _build, acquire_cuda, crc  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import graphs, trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.graphs import StepGraphs, arg_key, owned, stage  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples  # noqa: E402


def _copy_into(static, new):
    if isinstance(static, torch.Tensor):
        static.copy_(new)
    elif dataclasses.is_dataclass(static):
        for f in dataclasses.fields(static):
            _copy_into(getattr(static, f.name), getattr(new, f.name))
    elif isinstance(static, (tuple, list)):
        for s, n in zip(static, new):
            _copy_into(s, n)


class _FakeGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out


class FakeGraphs(StepGraphs):
    """:class:`StepGraphs` on CPU tensors with the capture stubbed. The
    current device is ``current`` (set by :meth:`_on`); ``devices`` has it
    at each capture and replay."""

    def __init__(self):
        super().__init__()
        self.captures = self.replays = 0
        self.current, self.devices = None, []

    def engages(self, x):
        return not trace.enabled()

    @contextmanager
    def _on(self, device):
        prev, self.current = self.current, device
        try:
            yield
        finally:
            self.current = prev

    def _capture(self, fn):
        self.captures += 1
        self.devices.append(self.current)
        out = fn()
        return _FakeGraph(fn, out), out

    def _replay(self, graph):
        self.replays += 1
        self.devices.append(self.current)
        before, counted = _build.launch_counts(), trace.counters()
        new = graph.fn()  # a graph's launches and counters are counted by StepGraphs.run
        _build.add_launch_counts({k: before[k] - n for k, n in _build.launch_counts().items()})
        for k, n in trace.counters().items():
            trace.count(k, counted.get(k, 0) - n)
        _copy_into(graph.out, new)


@pytest.fixture(autouse=True)
def _clean():
    trace.enable(False)
    trace.reset()
    yield
    trace.enable(False)
    trace.reset()


# ------------------------------------------------------------ a toy step


class Toy:
    """Two stages and the glue between them; each stage 'launches' one
    kernel of ``_build``'s counts."""

    def __init__(self):
        self.step_graphs = FakeGraphs()
        self.calls = 0

    @stage
    def scale(self, x, k=2):
        self.calls += 1
        _build.add_launch_counts({"fetch": 1})
        y = x * k
        return y, y.sum()

    @stage
    def shift(self, y, total):
        self.calls += 1
        _build.add_launch_counts({"matched": 1})
        return y + total

    def step(self, x, k=2, copy_glue=False):
        with self.step_graphs.step(x, k) as graphed:
            y, total = self.scale(x, k=k)
            out = (self.shift(y.clone() if copy_glue else y, total), total)
            return owned(out) if graphed else out


def _want(x, k=2):
    return x * k + (x * k).sum(), (x * k).sum()


def _counts(g):
    return [g.counts[n] for n in ("eager", "captured", "replayed", "evicted")]


def test_second_sight_captures_then_replays():
    toy = Toy()
    g = toy.step_graphs
    x = torch.arange(6.0)
    expect = [[1, 0, 0, 0], [1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 2, 0]]
    for i, want in enumerate(expect):
        out = toy.step(x)
        for a, b in zip(out, _want(x)):
            assert torch.equal(a, b)
        assert _counts(g) == want, i
        x.add_(1.0)  # the graphs read the bank where it lies: new samples, new results
    assert g.captures == 2 and g.replays == 2 + 2 * 2  # the capture step replays too
    assert len(g.chains) == 1 and g.chains[next(iter(g.chains))].ready


def test_step_results_are_the_callers_own():
    """A replayed step's results are copies in one buffer: the steps
    after it change none of them."""
    toy = Toy()
    x = torch.arange(6.0)
    outs = []
    for _ in range(10):
        outs.append((toy.step(x), [t.clone() for t in _want(x)]))
        x.mul_(1.5)
    for out, want in outs:
        for a, b in zip(out, want):
            assert torch.equal(a, b)
    last = outs[-1][0]
    assert last[0].untyped_storage().data_ptr() == last[1].untyped_storage().data_ptr()


@pytest.mark.parametrize("other", ["address", "shape", "strides", "dtype", "argument"])
def test_key_tells_inputs_apart(other):
    """A bank at another address, of another shape, with other strides or
    dtype, or another non-tensor argument opens a chain of its own: its
    first step runs eagerly."""
    toy = Toy()
    base = torch.arange(12.0)
    x, k = base[:6], 2
    for _ in range(2):
        toy.step(x, k)  # eager, then captured
    y, k2 = {
        "address": (base[6:], 2), "shape": (base[:5], 2), "strides": (base[::2], 2),
        "dtype": (base[:6].view(torch.int32), 2), "argument": (x, 3),
    }[other]
    assert arg_key(y) != arg_key(x) or k2 != k
    before = _counts(toy.step_graphs)
    out = toy.step(y, k2)
    for a, b in zip(out, _want(y, k2)):
        assert torch.equal(a, b)
    assert _counts(toy.step_graphs)[0] == before[0] + 1 and len(toy.step_graphs.chains) == 2
    toy.step(x, k)
    assert toy.step_graphs.counts["replayed"] == 1


def test_lru_bounds_the_chains(monkeypatch):
    """Capacity 2: a third key evicts the least recently used chain, and a
    key never seen twice in a row of the window is never captured."""
    monkeypatch.setattr(graphs, "CAPACITY", 2)
    toy = Toy()
    g = toy.step_graphs
    a, b, c = (torch.full((4,), float(v)) for v in (1, 2, 3))
    for x in (a, b, a):  # a: eager, captured; b: eager
        toy.step(x)
    toy.step(c)  # evicts b, the least recently used
    assert _counts(g) == [3, 1, 0, 1]
    toy.step(a)
    assert g.counts["replayed"] == 1
    toy = Toy()
    for _ in range(3):  # three keys in turn: each evicted before its second sight
        for x in (a, b, c):
            toy.step(x)
    assert _counts(toy.step_graphs) == [9, 0, 0, 7] and toy.step_graphs.captures == 0


def test_chain_dropped_when_a_stage_meets_other_inputs():
    """Glue that hands the second stage a new tensor every step: the
    capture step records it, the next step finds other inputs, drops the
    chain and finishes eagerly, with the right results."""
    toy = Toy()
    g = toy.step_graphs
    x = torch.arange(5.0)
    for i in range(4):
        out = toy.step(x, copy_glue=True)
        for a, b in zip(out, _want(x)):
            assert torch.equal(a, b)
    # eager, captured, dropped (eager), eager again (first sight)
    assert _counts(g) == [3, 1, 0, 1]


def test_tracing_on_runs_every_step_eagerly():
    toy = Toy()
    g = toy.step_graphs
    x = torch.arange(4.0)
    trace.enable(True)
    for _ in range(4):
        toy.step(x)
    trace.enable(False)
    assert _counts(g) == [4, 0, 0, 0] and not g.chains and g.captures == 0
    assert trace.totals()["counters"] == {"rx.graph.eager": 4}


def test_stage_outside_a_step_runs_eagerly():
    toy = Toy()
    x = torch.arange(4.0)
    for _ in range(3):
        toy.shift(*toy.scale(x))
    assert toy.calls == 6 and _counts(toy.step_graphs) == [0, 0, 0, 0] and toy.step_graphs.captures == 0


def test_launch_counts_are_the_eager_steps():
    """Every step adds the launches of one eager step: a capture takes
    back what it counted, and a replay adds it."""
    toy = Toy()
    x = torch.arange(4.0)
    _build.reset_launch_counts()
    for i in range(1, 5):
        toy.step(x)
        counts = _build.launch_counts()
        assert counts["fetch"] == i and counts["matched"] == i, counts
    assert _counts(toy.step_graphs) == [1, 1, 2, 0]
    _build.reset_launch_counts()


def test_counters_reach_trace_totals(monkeypatch):
    monkeypatch.setattr(graphs, "CAPACITY", 1)
    toy = Toy()
    x, y = torch.arange(3.0), torch.arange(4.0)
    for z in (x, x, x, y):
        toy.step(z)
    want = {"rx.graph.eager": 2, "rx.graph.captured": 1, "rx.graph.replayed": 1, "rx.graph.evicted": 1}
    assert trace.totals()["counters"] == want
    assert toy.step_graphs.counts == {k.split(".")[-1]: v for k, v in want.items()}


class CountingToy(Toy):
    """A toy whose first stage counts its rows, as the receiver's stages
    count the work their shapes set."""

    @stage
    def scale(self, x, k=2):
        trace.count("toy.rows", x.numel())
        return Toy.scale.__wrapped__(self, x, k)


def test_stage_counters_are_the_eager_steps():
    """Every step adds a stage's counters once: a capture takes back what
    it counted, and a replay adds it."""
    toy = CountingToy()
    x = torch.arange(5.0)
    for i in range(1, 5):
        toy.step(x)
        assert trace.counters()["toy.rows"] == 5 * i, trace.counters()
    assert _counts(toy.step_graphs) == [1, 1, 2, 0]


def test_step_runs_with_the_banks_device_current():
    """Every capture and replay of a step happens with the bank's device
    current (so on its device's stream, whichever device is current
    outside the step), and the device is restored after the step."""
    toy = Toy()
    g = toy.step_graphs
    x = torch.arange(4.0)
    for _ in range(4):
        toy.step(x)
    assert g.captures == 2 and g.replays == 6
    assert g.devices == [x.device] * 8 and g.current is None


def test_step_on_a_device_makes_it_current():
    """The real context of a step on ``cuda:1`` makes device 1 current
    (built here without touching CUDA), and a CPU bank never engages."""
    sg = StepGraphs()
    ctx = sg._on(torch.device("cuda", 1))
    assert isinstance(ctx, torch.cuda.device) and ctx.idx == 1
    assert not sg.engages(torch.zeros(3))


@pytest.mark.parametrize("cache", [crc._device_tables, crc._payload_device_tables, acquire_cuda._tables,
                                   acquire_cuda._bf16_device_tables])
def test_graphed_stages_device_tables_are_never_dropped(cache):
    """The caches of device tables that captured graphs read by address
    keep every entry: a dropped table's memory would be reused under a
    graph that still reads it."""
    assert cache.cache_info().maxsize is None


def test_flatten_detections_views_and_channel_ids():
    """Rows are views of the detections, channel-major; the channel ids
    are built or taken as given; ``overflow`` stays per channel."""
    rx = Receiver(RxConfig(**CFG, payload_carrier="vv"), "cpu")
    det = rx.acquirer.acquire(_bank(rx, 3, 0))
    detf, chan = flatten_detections(det)
    assert torch.equal(chan, torch.arange(3).repeat_interleave(CFG["max_detections"]))
    assert detf.index.data_ptr() == det.index.data_ptr() and torch.equal(detf.index, det.index.reshape(-1))
    assert detf.overflow.shape == (3,)
    ids = rx.channel_ids(3, CFG["max_detections"], det.index.device)
    assert flatten_detections(det, ids)[1] is ids
    assert rx.channel_ids(3, CFG["max_detections"], det.index.device) is ids


def test_failed_capture_drops_the_chain():
    class Failing(Toy):
        fail = False

        @stage
        def shift(self, y, total):
            if self.fail:
                raise RuntimeError("not capturable")
            return y + total

    toy = Failing()
    x = torch.arange(4.0)
    toy.step(x)
    toy.fail = True
    with pytest.raises(RuntimeError, match="not capturable"):
        toy.step(x)
    assert not toy.step_graphs.chains and toy.step_graphs.chain is None
    toy.fail = False
    toy.step(x)  # a first sight again
    assert _counts(toy.step_graphs) == [2, 0, 0, 1]


def test_owned_packs_one_buffer():
    """Mixed dtypes (widest first keeps every piece aligned), a 0-d flag,
    an empty tensor, a non-contiguous view and one tensor in two places."""
    @dataclasses.dataclass
    class R:
        a: torch.Tensor
        b: torch.Tensor
        c: torch.Tensor

    idx = torch.arange(7, dtype=torch.int64)
    flag = torch.tensor(True)
    byte = torch.arange(5, dtype=torch.uint8)
    f = torch.linspace(0, 1, 6).view(2, 3).t()  # non-contiguous
    col = torch.arange(12).view(4, 3)[:, 2]  # a strided column, as a header field is
    empty = torch.zeros(3, 0, 2)
    src = (R(idx, flag, byte), f, (idx, empty), torch.ones(3, dtype=torch.float64), col)
    out = owned(src)
    flat = [out[0].a, out[0].b, out[0].c, out[1], out[2][0], out[2][1], out[3], out[4]]
    for got, want in zip(flat, [idx, flag, byte, f, idx, empty, src[3], col]):
        assert got.dtype == want.dtype and got.shape == want.shape and torch.equal(got, want)
    storages = {t.untyped_storage().data_ptr() for t in flat if t.numel()}
    assert len(storages) == 1 and idx.untyped_storage().data_ptr() not in storages
    assert out[0].a is out[2][0]  # shared in, shared out
    idx.add_(1)
    assert torch.equal(out[0].a, torch.arange(7))


def test_owned_frees_its_buffer_with_the_last_reference():
    """With the cyclic garbage collector off, dropping ``owned``'s result
    frees the buffer at once: nothing else holds it (a step's copied-out
    results would otherwise linger until the collector runs, and a window's
    peak memory would follow the collector's phase)."""
    import gc
    import weakref

    src = (torch.arange(1000), torch.ones(10, dtype=torch.int8))
    gc.collect()
    gc.disable()
    try:
        out = owned(src)
        views = [weakref.ref(t) for t in out]
        del out
        assert all(v() is None for v in views)
    finally:
        gc.enable()


# -------------------------------------------------------- the receiver


CFG = dict(max_payload_len=128, max_detections=8, freq_bins=1)


def _bank(rx, channels, seed):
    rng = np.random.default_rng(4)
    burst = np.concatenate([burst_samples(rng.integers(0, 256, n, dtype=np.uint8), packet_index=i)
                            for i, n in enumerate((60, 128, 9))])
    fp = rx.front_pad
    x = torch.zeros(channels, fp + 8192 + rx.pad_tail(), dtype=torch.complex64)
    for c in range(channels):
        at = fp + 50 * c + 97 * seed
        x[c, at : at + burst.size] = torch.from_numpy((np.exp(0.3j * (c + seed)) * burst).astype(np.complex64))
    return x


def _graphed(rx):
    rx.step_graphs = rx.acquirer.step_graphs = FakeGraphs()
    return rx.step_graphs


def _assert_same(a, b):
    (da, ha, ra, ka), (db, hb, rb, kb) = a, b
    for x, y in ((da, db), (ha, hb), (ra, rb)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            assert u.dtype == v.dtype and torch.equal(u, v), f.name
    assert torch.equal(ka, kb)


@pytest.mark.parametrize("carrier,backend", [("vv", "fft"), ("costas", "fft"), ("vv", "fused")])
def test_receiver_graphed_steps_equal_eager(carrier, backend):
    """Two banks cycled three times through ``bank_step`` with the stages
    graphed: every step equals the eager step, the counts go eager,
    captured, replayed, and the results of each step outlive the steps
    after it. A chain is five graphs: acquisition's peak search and
    estimates, headers, suppression, payloads."""
    rx = Receiver(RxConfig(**CFG, payload_carrier=carrier, acquisition_backend=backend), "cpu")
    banks = [_bank(rx, 2, s) for s in range(2)]
    want = [rx.bank_step(x, 0) for x in banks]  # no graphs yet: eager
    g = _graphed(rx)
    got = []
    for i in range(6):
        got.append(rx.bank_step(banks[i % 2], 0))
    for i, out in enumerate(got):
        _assert_same(out, want[i % 2])
    assert int(got[-1][2].accepted.sum()) == 2 * 3
    assert rx.graph_counts() == {"captured": 2, "replayed": 2, "eager": 2, "evicted": 0}
    assert g.captures == 2 * 5
    assert got[-1][2].lengths.data_ptr() == got[-1][1].packet_length.data_ptr()


def test_receiver_grouped_step_and_outside_callers():
    """``bank_step(x, 2)`` on four channels graphs a chain of five graphs a
    group; ``receive`` and ``decode_bank`` outside a step stay eager."""
    rx = Receiver(RxConfig(**CFG, payload_carrier="vv"), "cpu")
    x = _bank(rx, 4, 0)
    want = rx.bank_step(x, 0)
    g = _graphed(rx)
    for _ in range(3):
        _assert_same(rx.bank_step(x, 2), want)
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
    assert g.captures == 2 * 5
    before = (rx.graph_counts(), g.captures, g.replays)
    rx.decode_bank(x, rx.acquirer.acquire(x))
    res = rx.receive(x[0, rx.front_pad : -rx.pad_tail()])
    assert int(res.accepted.sum()) == 3
    assert (rx.graph_counts(), g.captures, g.replays) == before


def test_receiver_new_tables_drop_the_chains():
    rx = Receiver(RxConfig(**CFG, payload_carrier="vv"), "cpu")
    x = _bank(rx, 2, 0)
    _graphed(rx)
    for _ in range(2):
        rx.bank_step(x, 0)
    assert len(rx.step_graphs.chains) == 1
    rx.load_tables({"arm_taps": rx.arm_taps.clone()})
    assert not rx.step_graphs.chains and rx.graph_counts()["evicted"] == 1
    rx.bank_step(x, 0)
    assert rx.graph_counts()["eager"] == 2


def test_receiver_graphed_steps_count_the_eager_work():
    """The receiver's work counters at a chunked payload pass (528 symbols
    in chunks of 64: nine, and one for the header pass): each step adds the
    same ``rx.extract.chunks`` and ``rx.payload.slot_symbols`` whether it
    ran eagerly, was captured or replayed, and the chunked step equals the
    one-chunk step."""
    rx = Receiver(RxConfig(**CFG, payload_carrier="vv", symbol_chunk=64), "cpu")
    x = _bank(rx, 2, 0)
    want = Receiver(RxConfig(**CFG, payload_carrier="vv"), "cpu").bank_step(x, 0)
    trace.reset()
    _graphed(rx)
    rows = 2 * CFG["max_detections"]
    for i in range(1, 4):
        _assert_same(rx.bank_step(x, 0), want)
        c = trace.counters()
        assert (c["rx.extract.chunks"], c["rx.payload.slot_symbols"]) == (10 * i, rows * 528 * i), c
    assert rx.graph_counts() == {"captured": 1, "replayed": 1, "eager": 1, "evicted": 0}
