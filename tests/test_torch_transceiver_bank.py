"""The port's bank of packet links (``models/transceiver.py``:
``TransceiverBank``, payloads in, TX, channel, ``Receiver.bank_step``,
packets out) against the benchmark's plain references on the CPU: two
links of a 2**17-sample block, four 1500-byte bursts a link a step, two
steps, so that each link's GLFSR ramp-down index is carried from the first
step into the second.

- ``Transmitter.burst_symbols_at``, as ``modulate_bank`` calls it, equals
  ``h100_bench/reference/transmitter.py``'s burst symbols bit for bit, and
  the TX bank its bank within 1e-5 (the port's TX tests hold its samples
  to the JAX TX's within 1e-5: float32 FIR sums in another order);
- ``ragged_concat`` over a bank's rows, each from its own offset, equals
  the 1-D form row by row;
- every payload decodes byte-exact, and the step's rows equal
  ``ReferenceReceiver``'s on the same received bank;
- the counters ``tx.packets`` and ``tx.samples`` count once a step, and
  the spans ``tx.step`` (``.frame``, ``.shape``, ``.layout``) and
  ``channel.impair`` are in the span tree.

The receiver runs the V&V payload carrier here (the plain Costas loop
costs seconds a step on the CPU); the card's test
(``tests/test_torch_cuda.py::test_transceiver_bank_step``) runs the
cell's Costas carrier.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.models.receiver import RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transceiver import TransceiverBank  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants as C  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat  # noqa: E402
from h100_bench import correct  # noqa: E402
from h100_bench.reference.receiver import ReferenceReceiver  # noqa: E402
from h100_bench.reference.transmitter import ReferenceTransmitter  # noqa: E402

LINKS, BURSTS, BLOCK, LEN = 2, 4, 1 << 17, 1500
RX = dict(max_payload_len=1536, max_detections=8, freq_bins=4, acquisition_backend="fused",
          acquisition_fft_size=2048, payload_carrier="vv")
BURST_LEN = 4 * C.burst_symbols(LEN)  # 24,912 samples


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread: under the six-worker Tier-1 run the workers'
    thread pools contend, and the reference receiver's small operations
    took 130 s there against 0.5 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def loop_run(_one_thread):
    """Two steps of the loop: each step's inputs, outputs, TX bank, received
    bank and counters."""
    rng = np.random.default_rng(23)
    loop = TransceiverBank(TxConfig(max_payload_len=1536), RxConfig(**RX), LINKS, BURSTS, BLOCK, "cpu",
                           generator=torch.Generator().manual_seed(5))
    slack = BLOCK - BURSTS * BURST_LEN
    steps = []
    trace.reset()
    for _ in range(2):
        data = np.zeros((LINKS, BURSTS, 1536), np.uint8)
        data[..., :LEN] = rng.integers(0, 256, (LINKS, BURSTS, LEN))
        inputs = (torch.from_numpy(data), torch.full((LINKS, BURSTS), LEN),
                  torch.from_numpy(rng.integers(0, slack + 1, LINKS)),
                  torch.from_numpy(rng.uniform(-0.006, 0.006, LINKS)),
                  torch.from_numpy(rng.uniform(-np.pi, np.pi, LINKS)))
        index = loop.tx_index.clone()
        before = trace.counters()
        out, host = loop.step(*inputs)
        after = trace.counters()
        added = {n: after.get(n, 0) - before.get(n, 0) for n in ("tx.packets", "tx.samples")}
        steps.append({"inputs": inputs, "index": index, "out": out, "host": host,
                      "tx": loop.tx_bank.clone(), "bank": loop.bank.clone(), "counters": added})
    return loop, steps


def test_glfsr_index_carried_across_steps(loop_run):
    loop, steps = loop_run
    assert steps[0]["index"].tolist() == [0] * LINKS
    assert steps[1]["index"].tolist() == [BURSTS] * LINKS
    assert loop.tx_index.tolist() == [2 * BURSTS] * LINKS


def test_burst_symbols_equal_reference(loop_run):
    """Each link's bursts at its carried GLFSR index, in both steps."""
    loop, steps = loop_run
    ref = ReferenceTransmitter(torch.device("cpu"))
    for s, step in enumerate(steps):
        data = step["inputs"][0].numpy()
        for c in range(LINKS):
            index = s * BURSTS + torch.arange(BURSTS)
            got, lens = loop.tx.burst_symbols_at(PacketBatch(step["inputs"][0][c], step["inputs"][1][c]), index)
            want, want_lens = ref.burst_symbols([ref.data_symbols(p[:LEN]) for p in data[c]], index.numpy())
            assert lens.tolist() == want_lens.tolist() == [C.burst_symbols(LEN)] * BURSTS
            assert torch.equal(got[:, : want.shape[1]], want)
            assert not got[:, want.shape[1]:].any()


def test_tx_bank_equals_reference(loop_run):
    _, steps = loop_run
    ref = ReferenceTransmitter(torch.device("cpu"))
    for s, step in enumerate(steps):
        data, offset = step["inputs"][0].numpy(), step["inputs"][2].numpy()
        frames = [[ref.data_symbols(p[:LEN]) for p in row] for row in data]
        want = ref.bank(frames, np.full(LINKS, s * BURSTS), offset, BLOCK)
        assert float((step["tx"] - want).abs().max()) < 1e-5
        for c in range(LINKS):  # zeros around the bursts
            a, b = int(offset[c]), int(offset[c]) + BURSTS * BURST_LEN
            assert not step["tx"][c, :a].any() and not step["tx"][c, b:].any()
            assert step["tx"][c, a].abs() > 0 and step["tx"][c, b - 1 - 4 * C.RRC_FLUSH_SYMBOLS].abs() > 0


def test_ragged_concat_rows_equal_one_dimensional():
    """A bank's rows, each from its own offset (one past the output's end),
    against the 1-D form of each row shifted by its offset."""
    rng = np.random.default_rng(8)
    data = torch.from_numpy((rng.standard_normal((3, 4, 9)) + 1j * rng.standard_normal((3, 4, 9))).astype(np.complex64))
    lens = torch.tensor([[3, 0, 9, 2], [9, 9, 9, 9], [1, 5, 0, 4]])
    offset = torch.tensor([0, 4, 30])
    got, total = ragged_concat(data, lens, 30, offset=offset)
    assert total.tolist() == lens.sum(1).tolist()
    for c in range(3):
        row, n = ragged_concat(data[c], lens[c], 30)
        want = torch.zeros(30, dtype=torch.complex64)
        o = int(offset[c])
        want[o:] = row[: max(0, 30 - o)]
        assert int(n) == int(total[c]) and torch.equal(got[c], want), c


def test_every_payload_decodes(loop_run):
    """Every payload of both steps on the host, byte-exact, at its burst."""
    loop, steps = loop_run
    d, fp = RX["max_detections"], loop.rx.front_pad
    for step in steps:
        data, offset = step["inputs"][0].numpy(), step["inputs"][2].numpy()
        truth = [[(fp + int(offset[c]) + k * BURST_LEN, c * BURSTS + k, True) for k in range(BURSTS)]
                 for c in range(LINKS)]
        host = step["host"]
        assert host.crc_ok.all() and (host.length == LEN).all()
        packets = [(int(r) // d, int(i), host.data[j, :LEN].numpy())
                   for j, (r, i) in enumerate(zip(host.row, host.index))]
        m = correct.match_truth(packets, truth, data.reshape(-1, 1536)[:, :LEN])
        assert m == {"missed": 0, "false": 0, "dup": 0, "expected": LINKS * BURSTS}, m


def test_rows_equal_the_reference(loop_run):
    _, steps = loop_run
    step = steps[1]
    det, hdr, res, keep = step["out"]
    t = {"index": det.index, "valid": det.valid, "esn0_db": det.esn0_db, "header_ok": hdr.header_ok,
         "length": hdr.packet_length, "packet_type": hdr.packet_type, "keep": keep,
         "crc_ok": res.crc_ok, "accepted": res.accepted}
    prog = {k: v.numpy().reshape(LINKS, -1) for k, v in t.items()}
    prog["data"] = res.data.numpy().reshape(LINKS, RX["max_detections"], -1)
    r = correct.compare_rows(prog, ReferenceReceiver(RX, torch.device("cpu")).decode(step["bank"]))
    assert r["det_diff"] == 0 and r["row_diff"] == 0 and r["esn0_gap_db"] < 1e-3, r


def test_counters_once_a_step(loop_run):
    _, steps = loop_run
    for step in steps:
        assert step["counters"] == {"tx.packets": LINKS * BURSTS, "tx.samples": LINKS * BLOCK}


def test_spans_of_the_loop(loop_run):
    """With tracing on, a step's span tree holds the TX's and the channel's
    spans under their parents, each called once."""
    loop, steps = loop_run
    trace.enable(True)
    try:
        trace.reset()
        loop.step(*steps[0]["inputs"])
        spans = trace.totals()["spans"]
        parents = {r.name: r.parent for r in trace.records()}
    finally:
        trace.enable(False)
        trace.reset()
    for name in ("tx.step", "tx.step.frame", "tx.step.shape", "tx.step.layout", "channel.impair"):
        assert spans[name]["calls"] == 1, name
    assert parents["tx.step"] is None and parents["channel.impair"] is None
    assert all(parents[f"tx.step.{n}"] == "tx.step" for n in ("frame", "shape", "layout"))
