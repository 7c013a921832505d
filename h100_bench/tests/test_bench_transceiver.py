"""The transceiver cell on the CPU at a tiny size (two links of a
2**17-sample block, four bursts a link a step, the V&V carrier, three
warm-up steps): a sound run is correct; each planted fault (a payload byte
flipped before the TX, one TX sample altered, one burst moved by a sample)
makes it not correct; ``tx_work.py`` counts the bytes a TX step must move;
the cell's new readers return None on an empty record."""

import json

import pytest
import torch

from h100_bench import tx_work
from h100_bench.reference import constants as C
from h100_bench.run import HERE, load_module, run_cell

SEED = 2**33 + 23023
BURSTS = 4
BURST_LEN = 4 * C.burst_symbols(1500)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def trx_dir(bench_dir):
    cfg = json.loads((bench_dir / "configs" / "trx_costas.json").read_text())
    cfg["block"] = 1 << 17
    (bench_dir / "configs" / "trx_costas.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "loop1500_64ch.json").read_text())
    mix["bursts"] = BURSTS
    (bench_dir / "traffic" / "loop1500_64ch.json").write_text(json.dumps(mix))
    return bench_dir


def _run(manifest, bench_dir, fault=None):
    hooks = {"rx": {"payload_carrier": "vv"}, "warm_steps": 3}
    if fault:
        hooks["fault"] = fault
    return run_cell(manifest, "trx64_loop", SEED, 1.5, False, torch.device("cpu"), bench_dir=bench_dir,
                    hooks=hooks)[0]


def test_sound_run_is_correct(manifest, trx_dir):
    r = _run(manifest, trx_dir)
    assert r["correct"] and r["attempted"] >= 2 * 2 * BURSTS and r["failed"] == 0, r["checks"]
    assert {"rx_sps", "latency_p95_ms", "setup_s"} <= set(r["metrics"])


def _payload_flipped(loop):
    stage = loop.stage

    def flipped(*args):
        stage(*args)
        loop.data[1, 2, 7] ^= 0x5A

    loop.stage = flipped


def _sample_altered(loop):
    transmit = loop.transmit

    def altered():
        x = transmit()
        x[0, int(loop.offset[0]) + 5000] += 1e-3
        return x

    loop.transmit = altered


def _burst_shifted(loop):
    transmit = loop.transmit

    def shifted():  # link 1's first burst one sample late
        x = transmit()
        a = int(loop.offset[1])
        x[1, a + 1 : a + BURST_LEN + 1] = x[1, a : a + BURST_LEN].clone()
        x[1, a] = 0
        return x

    loop.transmit = shifted


@pytest.mark.parametrize("fault,fails", [(_payload_flipped, "false"), (_sample_altered, "tx_diff"),
                                         (_burst_shifted, "tx_diff")], ids=["payload_flipped",
                                                                            "sample_altered", "burst_shifted"])
def test_fault_is_not_correct(manifest, trx_dir, fault, fails):
    r = _run(manifest, trx_dir, fault)
    assert not r["correct"]
    assert r["checks"][fails]["value"] > r["checks"][fails]["limit"], r["checks"]


def test_tx_work_bytes():
    """The cell's step: 1344 payloads of 1500 B read, 64 x 2**19 complex64
    samples written."""
    assert tx_work.tx_bytes(1344 * 1500, 64, 1 << 19) == 2_016_000 + 268_435_456


@pytest.mark.parametrize("name", ["tx_ms.loop", "channel_ms.loop", "tx_roofline_pct.loop"])
def test_readers_none_on_empty_record(name):
    read = load_module(HERE / "metrics" / f"{name}.py").read
    assert read({}) is None
    assert read({"profile": {"whole": False}, "work": {}}) is None
