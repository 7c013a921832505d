"""The cell ``costas64_mixed4k`` on the CPU (``run_cell`` with the card's
check skipped), at its own 2^19-sample block so that 4096-byte packets lie
whole, cut to two channels, one bank, one payload a length and one
warm-up pass: a sound run is correct, with the payload fill read from the
program's counter; a byte altered late in a packet longer than 2,044
bytes, in a later chunk of the chunked extraction, makes it not correct.
The extraction's work is counted by the algorithm, the same for every
chunk size, and the new readers read nothing from an empty record."""

import json

import pytest
import torch

from h100_bench import extract_work, run
from h100_bench.run import load_module, run_cell

SEED = 2**33 + 12345
CELL = "costas64_mixed4k"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def mixed_dir(bench_dir):
    """The tiny copy with the cell's configuration at its own block and
    slots, and its mix at one bank and one payload a length."""
    own = json.loads((run.HERE / "configs" / "rx_costas_mixed4k.json").read_text())
    f = bench_dir / "configs" / "rx_costas_mixed4k.json"
    cfg = json.loads(f.read_text())
    cfg["block"], cfg["rx"]["max_detections"] = own["block"], own["rx"]["max_detections"]
    f.write_text(json.dumps(cfg))
    f = bench_dir / "traffic" / "mixed4k_64ch.json"
    f.write_text(json.dumps({**json.loads(f.read_text()), "blocks": 1, "pool": 1}))
    return bench_dir


def _run(manifest, bench_dir, monkeypatch, fault=None):
    made = []

    class Kept(run.Ctx):  # the run's context, to read its record afterwards
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(run, "Ctx", Kept)
    hooks = {"warm_passes": 1, **({"fault": fault} if fault else {})}
    result, _ = run_cell(manifest, CELL, SEED, 0.5, False, torch.device("cpu"), bench_dir=bench_dir, hooks=hooks)
    return result, made[0].record


def _alter_long_packet(out):
    det, hdr, res, keep = out
    rows = (res.accepted & (res.lengths > 2044)).nonzero().squeeze(1)
    if not len(rows):
        raise AssertionError("no packet longer than 2,044 bytes was accepted")
    n = int(res.lengths[rows[0]])
    res.data[rows[0], n - 1] ^= 0x5A  # the last byte: symbols past the first chunks
    return out


def test_sound_run_is_correct_and_reads_the_fill(manifest, mixed_dir, monkeypatch):
    r, rec = _run(manifest, mixed_dir, monkeypatch)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0, r["checks"]
    fill = load_module(run.HERE / "metrics" / "payload_fill_pct.rx.py").read(rec)
    assert 5 < fill < 20, fill  # the mix's 778 B average in 4096-byte slots, about 40 of 56 slots
    assert rec["work"]["extract_least_s"] > 0


def test_altered_long_packet_is_not_correct(manifest, mixed_dir, monkeypatch):
    r, _ = _run(manifest, mixed_dir, monkeypatch, fault=_alter_long_packet)
    assert not r["correct"] and r["checks"]["false"]["value"] >= 1, r["checks"]


def test_extraction_bytes_ignore_the_chunking():
    rx = json.loads((run.HERE / "configs" / "rx_costas_mixed4k.json").read_text())["rx"]
    rows, taps = 64 * 56, 45
    counts = {extract_work.step_extraction_bytes(rows, {**rx, "symbol_chunk": n}, taps)
              for n in (64, 2048, 16400, 1 << 20)}
    per_row = sum((4 * (s - 1) + taps) * 8 + taps * 4 + s * 8 for s in (192, 16400))
    assert counts == {rows * per_row}


def test_new_readers_read_nothing_from_an_empty_record():
    for name in ("payload_fill_pct.rx", "extract_roofline_pct.rx"):
        assert load_module(run.HERE / "metrics" / f"{name}.py").read({}) is None
