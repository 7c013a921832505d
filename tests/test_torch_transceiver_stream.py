"""The port's bank of packet links in stream mode (``models/transceiver.py``:
``TransceiverBank.stream_step``; upstream's ``--stream``) on the CPU: two
links of a 2**14-sample block, each sending back to back seeded
permutations of 9 user packets (40-200 bytes) and 7 IDLE packets (32
bytes), four steps, so that packets cross every step edge.

- each row of the stream bank TX (``Transmitter.modulate_stream_bank``,
  backlog and FIR history carried) equals the 1-D
  ``Transmitter.modulate_stream`` of that link's packets over three
  steps, bit for bit;
- every user packet whose syncword lies in a step's fresh window is
  delivered once, byte-exact, those cut by a step edge too, and no IDLE
  packet is delivered;
- the delivered packets equal a one-shot ``Receiver`` decode of the
  received stream laid end to end;
- each step's handed-on suppression state and packets equal
  ``StreamingBank``'s on the same received blocks;
- the counters ``tx.packets``, ``tx.idle_packets`` and the receiver's
  stream row counts, and the span ``rx.slide``.

The receiver runs the V&V payload carrier here (the plain Costas loop
costs seconds a step on the CPU); the card's test
(``tests/test_torch_cuda.py::test_transceiver_stream_graphed_equals_eager``)
runs the Costas carrier, graphed against eager.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.models.receiver import IDLE_BUSY, Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch  # noqa: E402

LINKS, BLOCK, STEPS, SPS, MAXLEN, IDLE_LEN = 2, 1 << 14, 4, 4, 256, 32
SYMS = BLOCK // SPS  # symbols a link a step
SLOTS = 16  # packets that may start in a link's step, and detection slots
RX = dict(max_payload_len=MAXLEN, max_detections=SLOTS, freq_bins=4, acquisition_backend="fused",
          acquisition_fft_size=2048, payload_carrier="vv")
IDLE = int(C.PacketType.IDLE)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the six-worker Tier-1 run the workers'
    thread pools contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _schedule(rng):
    """Per link, ``(start symbol, payload, type)`` of each packet, back to
    back from symbol 0, past the last step's end."""
    links = []
    for c in range(LINKS):
        packets, pos, seq = [], 0, 0
        while pos < (STEPS + 1) * SYMS:
            for t in rng.permutation([0] * 9 + [IDLE] * 7):
                if t == IDLE:
                    p = ((np.arange(IDLE_LEN) + seq) % 255).astype(np.uint8)
                    seq += 1
                else:
                    p = rng.integers(0, 256, int(rng.integers(40, 201)), dtype=np.uint8)
                packets.append((pos, p, int(t)))
                pos += C.stream_symbols(p.size)
        links.append(packets)
    return links


def _step_inputs(links, i):
    """The packets that start in step ``i`` of each link, staged."""
    data = np.zeros((LINKS, SLOTS, MAXLEN), np.uint8)
    lengths = np.zeros((LINKS, SLOTS), np.int64)
    types = np.zeros((LINKS, SLOTS), np.int64)
    for c, packets in enumerate(links):
        mine = [p for p in packets if i * SYMS <= p[0] < (i + 1) * SYMS]
        assert len(mine) <= SLOTS
        for k, (_, p, t) in enumerate(mine):
            data[c, k, : p.size], lengths[c, k], types[c, k] = p, p.size, t
    return tuple(torch.from_numpy(a) for a in (data, lengths, types))


@pytest.fixture(scope="module")
def stream_run(_one_thread):
    """Four steps of the loop: each step's inputs, outputs, TX block, bank,
    handed-on suppression state and counters."""
    rng = np.random.default_rng(25)
    links = _schedule(rng)
    loop = TransceiverBank(TxConfig(max_payload_len=MAXLEN, stream_mode=True), RxConfig(**RX), LINKS, SLOTS,
                           BLOCK, "cpu", generator=torch.Generator().manual_seed(7))
    loop.tune(torch.from_numpy(rng.uniform(-0.006, 0.006, LINKS)), torch.from_numpy(rng.uniform(-np.pi, np.pi, LINKS)))
    trace.reset()
    steps = []
    for i in range(STEPS):
        inputs = _step_inputs(links, i)
        before = trace.counters()
        out, host = loop.stream_step(*inputs)
        after = trace.counters()
        added = {n: after.get(n, 0) - before.get(n, 0) for n in ("tx.packets", "tx.idle_packets")}
        steps.append({"inputs": inputs, "out": out, "host": host, "tx": loop.tx_bank.clone(),
                      "bank": loop.bank.clone(), "busy": loop.busy.clone(), "counters": added})
    return loop, links, steps


def _delivered(loop, steps):
    """``{(link, absolute sample of the syncword, bytes)}`` over the steps."""
    d, keep = RX["max_detections"], loop.bank.shape[1] - BLOCK
    out = set()
    for i, step in enumerate(steps):
        h = step["host"]
        for j in range(h.row.numel()):
            n = int(h.length[j])
            out.add((int(h.row[j]) // d, i * BLOCK + int(h.index[j]) - keep, h.data[j, :n].numpy().tobytes()))
    return out


def test_stream_bank_tx_equals_one_dimensional(stream_run):
    """Three steps of each link, laid end to end, against ``modulate_stream``
    of the link's packets from the stream's start: every edge carries its
    cut packet's symbols and the FIR history."""
    loop, links, steps = stream_run
    got = torch.cat([s["tx"] for s in steps[:3]], dim=1)
    for c, packets in enumerate(links):
        mine = [(p, t) for s, p, t in packets if s < 3 * SYMS]
        batch = PacketBatch.from_list([p for p, _ in mine], MAXLEN, "cpu", types=[t for _, t in mine])
        _, want, total = loop.tx.modulate_stream(batch, 3 * SYMS)
        assert int(total) > 3 * BLOCK  # a packet crosses the third step's end
        assert torch.equal(got[c], want), c


def test_every_user_packet_delivered_once(stream_run):
    """Each user packet whose syncword lies in one of the four fresh
    windows, once, byte-exact (the packets cut by a step edge among them),
    and nothing else: no IDLE packet, no duplicate."""
    loop, links, steps = stream_run
    pt = loop.rx.pad_tail()
    want = {(c, SPS * s, p.tobytes()) for c, packets in enumerate(links) for s, p, t in packets
            if t != IDLE and SPS * s < STEPS * BLOCK - pt}
    cut = {(c, SPS * s) for c, packets in enumerate(links) for s, p, t in packets
           if t != IDLE and any(s < k * SYMS < s + C.stream_symbols(p.size) for k in range(1, STEPS))}
    got = _delivered(loop, steps)
    assert got == want
    assert len(cut) >= 2 and cut <= {(c, a) for c, a, _ in got}
    for step in steps:
        _, hdr, res, _ = step["out"]
        assert not (res.accepted & (hdr.packet_type == IDLE)).any()


def test_delivered_equal_one_shot_decode(stream_run):
    """The received blocks laid end to end and decoded in one piece (one
    receiver, slots for every packet): the same packets, up to the last
    step's fresh window."""
    loop, _, steps = stream_run
    rx = Receiver(RxConfig(**{**RX, "max_detections": 64}), "cpu")
    x = rx.pad(torch.cat([s["bank"][:, -BLOCK:] for s in steps], dim=1))
    d = rx.decode(x, rx.acquirer.acquire(x))
    fp, pt = rx.front_pad, loop.rx.pad_tail()
    one_shot = set()
    for r in d.res.accepted.nonzero().squeeze(1).tolist():
        a = int(d.det.index[r]) - fp
        if a < STEPS * BLOCK - pt:
            n = int(d.res.lengths[r])
            one_shot.add((r // 64, a, d.res.data[r, :n].numpy().tobytes()))
    assert one_shot and one_shot == _delivered(loop, steps)


def test_busy_state_and_packets_equal_streaming_bank(stream_run):
    """``StreamingBank`` fed the same received blocks: after each block its
    carried suppression state equals the stream step's, and its packets
    equal the stream's delivered ones."""
    loop, _, steps = stream_run
    sb = StreamingBank(RxConfig(**RX), "cpu", channels=LINKS, block=BLOCK, pipeline_depth=1, group=0)
    packets = []
    for step in steps:
        packets += sb.process(step["bank"][:, -BLOCK:].numpy())
        assert torch.equal(sb._busy, step["busy"])
    assert all(int(s["busy"].min()) > IDLE_BUSY for s in steps)
    packets += sb._drain()
    got = {(p.channel, p.index, p.data.tobytes()) for p in packets}
    assert got == _delivered(loop, steps)


def test_counters_and_slide_span(stream_run):
    """``tx.packets`` and ``tx.idle_packets`` count the packets handed in a
    step; the receiver's stream row counts hold every decoded packet, the
    IDLE ones apart; with tracing on a step's span tree holds ``rx.slide``
    and ``rx.hand_on``."""
    loop, links, steps = stream_run
    for step in steps:
        lengths, types = step["inputs"][1], step["inputs"][2]
        assert step["counters"] == {"tx.packets": int((lengths > 0).sum()),
                                    "tx.idle_packets": int(((lengths > 0) & (types == IDLE)).sum())}
    good = sum(int((s["out"][1].header_ok & s["out"][3]).sum()) for s in steps)
    idle = sum(int((s["out"][1].header_ok & s["out"][3] & (s["out"][1].packet_type == IDLE)).sum())
               for s in steps)
    assert idle > 0 and good > idle
    assert loop.rx.stream_rows() == {"header_ok": good, "idle": idle}
    trace.enable(True)
    try:
        trace.reset()
        loop.stream_step(*_step_inputs(links, STEPS))
        spans = trace.totals()["spans"]
        parents = {r.name: r.parent for r in trace.records()}
    finally:
        trace.enable(False)
        trace.reset()
    for name in ("rx.slide", "tx.step", "channel.impair", "rx.hand_on"):
        assert spans[name]["calls"] == 1, name
    assert parents["rx.slide"] is None and parents["rx.hand_on"] == "rx.step"


def test_stream_mode_refuses_a_short_block():
    """A block shorter than what the sliding bank keeps from step to step
    is refused, as is ``stream_step`` on a burst-mode bank."""
    with pytest.raises(ValueError, match="stream-mode block"):
        TransceiverBank(TxConfig(max_payload_len=MAXLEN, stream_mode=True), RxConfig(**RX), 1, 4, 1 << 12, "cpu")
    burst = TransceiverBank(TxConfig(max_payload_len=MAXLEN), RxConfig(**RX), 1, 4, BLOCK, "cpu")
    with pytest.raises(RuntimeError, match="stream_mode"):
        burst.stream_step(*_step_inputs([[]], 0))
