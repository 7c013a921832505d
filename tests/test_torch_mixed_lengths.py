"""Upstream's loopback packet mix through ``Receiver.bank_step`` at a
4096-byte payload bound, held against the benchmark's plain reference
receiver (``h100_bench/reference/receiver.py``).

The 15 packet lengths of upstream's test/qa_loopback.cpp:31-49 (10 to
4096 bytes) lie back to back on each of two channels, in upstream's order
on channel 0 and reversed on channel 1, so that a 4096-byte packet lies
whole in the bank of each; the channels are rotated by two of upstream's
carrier offsets (+0.006 and -0.02 rad/sample, :134-140) and noised at 0.05
a component (:66). At ``max_payload_len=4096`` a payload slot is 16,400
symbols, which the extraction runs in nine 2048-symbol chunks (one more
for the 192 header symbols). The port's rows (valid detections, header
fields, keep, CRC and accept flags, bytes) must equal the reference's,
which extracts each region in one piece; every packet must decode
byte-exact; and the step's work counters must read the chunks and the
slot-symbols that the shapes set.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import trace  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.stimulus import burst_samples  # noqa: E402
from h100_bench import correct  # noqa: E402
from h100_bench.reference.receiver import ReferenceReceiver  # noqa: E402

LENGTHS = [10, 25, 100, 1500, 27, 38, 243, 514, 1500, 1500, 1024, 1024, 42, 34, 4096]
CFOS = (0.006, -0.02)
RX = dict(max_payload_len=4096, max_detections=20, freq_bins=4, acquisition_backend="fused",
          acquisition_fft_size=2048, payload_carrier="costas")
BLOCK = 1 << 18
SLOT_SYMS = 4 * (4096 + 4)


@pytest.fixture(scope="module")
def mixed():
    """The bank ``[2, T]``, each channel's transmitted ``(start, payload)``,
    and the port's and the reference's rows, with the counters of the
    port's step."""
    rng = np.random.default_rng(19)
    payloads = [rng.integers(0, 256, n, dtype=np.uint8) for n in LENGTHS]
    bursts = [burst_samples(p, packet_index=i) for i, p in enumerate(payloads)]
    rx = Receiver(RxConfig(**RX), "cpu")
    fp = rx.front_pad
    x = np.zeros((2, fp + BLOCK + rx.pad_tail()), np.complex64)
    sent = []
    t = np.arange(BLOCK)
    for c, cfo in enumerate(CFOS):
        order = range(len(LENGTHS)) if c == 0 else reversed(range(len(LENGTHS)))
        at, row, chan = 1000 + 3000 * c, np.zeros(BLOCK, np.complex64), []
        for i in order:
            row[at : at + bursts[i].size] = bursts[i]
            chan.append((fp + at, payloads[i]))
            at += bursts[i].size
        assert at <= BLOCK
        noise = 0.05 * (rng.standard_normal(BLOCK) + 1j * rng.standard_normal(BLOCK))
        x[c, fp : fp + BLOCK] = row * np.exp(1j * (cfo * t + 0.7 * c)) + noise
        sent.append(chan)
    bank = torch.from_numpy(x)
    trace.reset()
    det, hdr, res, keep = rx.bank_step(bank, 0)
    counters = trace.counters()
    trace.reset()
    d = RX["max_detections"]
    prog = {"index": det.index, "valid": det.valid, "esn0_db": det.esn0_db, "header_ok": hdr.header_ok,
            "length": hdr.packet_length, "packet_type": hdr.packet_type, "keep": keep,
            "crc_ok": res.crc_ok, "accepted": res.accepted}
    prog = {k: v.numpy().reshape(2, d) for k, v in prog.items()}
    prog["data"] = res.data.numpy().reshape(2, d, -1)
    ref = ReferenceReceiver(RX, torch.device("cpu")).decode(bank)
    return sent, prog, ref, counters


def test_rows_equal_the_reference(mixed):
    _, prog, ref, _ = mixed
    r = correct.compare_rows(prog, ref)
    assert r["det_diff"] == 0 and r["row_diff"] == 0, r
    assert r["esn0_gap_db"] <= 1e-3, r
    assert int(prog["valid"].sum()) == int(ref["valid"].sum()) >= 2 * len(LENGTHS)


def test_every_packet_decodes_whole(mixed):
    sent, prog, _, _ = mixed
    for c, chan in enumerate(sent):
        got = {}
        for k in np.nonzero(prog["accepted"][c])[0]:
            got[int(prog["index"][c, k])] = prog["data"][c, k, : int(prog["length"][c, k])]
        assert len(got) == len(LENGTHS), (c, sorted(got))
        for (start, payload), (index, data) in zip(chan, sorted(got.items())):
            assert abs(index - start) <= correct.MATCH_TOL and np.array_equal(data, payload), (c, len(payload))


def test_counters_read_the_chunked_work(mixed):
    *_, counters = mixed
    assert counters["rx.extract.chunks"] == 1 + 9
    assert counters["rx.payload.slot_symbols"] == 2 * RX["max_detections"] * SLOT_SYMS
