"""The stream transceiver cell on the CPU at a tiny size (two links of a
2**16-sample block, 12 detection slots, the V&V carrier, four warm-up
steps): a sound run is correct, and each planted fault makes it not
correct by the check it should fail: the FIR history zeroed each step
(``tx_diff``), the channel's phase not carried (``channel_diff``), the
suppression state reset after each step (``carry_diff``), an IDLE packet
accepted (``false``); the schedule stages the packets that start in a
step, each once; the cell's new readers return None on an empty record;
the reference stands alone."""

import json

import numpy as np
import pytest
import torch

from h100_bench import guard
from h100_bench.entries import transceiver_stream as entry
from h100_bench.run import HERE, load_module, run_cell

SEED = 2**33 + 25025
MIX = "stream1500idle_64ch"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def stream_dir(bench_dir):
    mix = json.loads((bench_dir / "traffic" / f"{MIX}.json").read_text())
    mix["packets"] = 12
    (bench_dir / "traffic" / f"{MIX}.json").write_text(json.dumps(mix))
    return bench_dir


def _run(manifest, bench_dir, fault=None):
    hooks = {"rx": {"payload_carrier": "vv", "max_detections": 12}, "warm_steps": 4}
    if fault:
        hooks["fault"] = fault
    return run_cell(manifest, "trx64_stream", SEED, 1.0, False, torch.device("cpu"), bench_dir=bench_dir,
                    hooks=hooks)[0]


def test_sound_run_is_correct(manifest, stream_dir):
    r = _run(manifest, stream_dir)
    assert r["correct"] and r["attempted"] >= 6 and r["failed"] == 0, r["checks"]
    assert {"rx_sps", "latency_p95_ms", "setup_s"} <= set(r["metrics"])


def _history_zeroed(loop):
    transmit = loop.transmit

    def zeroed():
        loop.carry = loop.carry._replace(history=torch.zeros_like(loop.carry.history))
        return transmit()

    loop.transmit = zeroed


def _phase_not_carried(loop):
    impair = loop.impair

    def held(x):
        phase = loop.phase.clone()
        out = impair(x)
        loop.phase.copy_(phase)
        return out

    loop.impair = held


def _busy_reset(loop):
    stream_step = loop.stream_step

    def reset(*args):
        out = stream_step(*args)
        loop.busy.fill_(-(1 << 30))
        return out

    loop.stream_step = reset


def _idle_accepted(loop):
    to_host = loop.to_host

    def accepted(out):
        _, hdr, res, keep = out
        res.accepted |= keep & hdr.header_ok & (hdr.packet_type == entry.IDLE)
        return to_host(out)

    loop.to_host = accepted


@pytest.mark.parametrize("fault,fails", [(_history_zeroed, "tx_diff"), (_phase_not_carried, "channel_diff"),
                                         (_busy_reset, "carry_diff"), (_idle_accepted, "false")],
                         ids=["history_zeroed", "phase_not_carried", "busy_reset", "idle_accepted"])
def test_fault_is_not_correct(manifest, stream_dir, fault, fails):
    r = _run(manifest, stream_dir, fault)
    assert not r["correct"]
    assert r["checks"][fails]["value"] > r["checks"][fails]["limit"], r["checks"]


def test_schedule_stages_each_packet_once():
    """Steps of a link's symbols stage the packets that start in them, back
    to back, every one once, IDLE fills numbered along the link."""
    mix = {"payload_len": 1500, "idle_len": 256, "data": 9, "idle": 7, "groups": 2, "pool": 5}
    sched = entry.Schedule(SEED, mix, 3, 1536)
    syms, slots = 16384, 12
    assert sched.cycle == 2 * (9 * 6208 + 7 * 1232)
    assert sched.most_starts(syms) <= slots
    tensors = {"data": torch.zeros(3, slots, 1536, dtype=torch.uint8),
               "lengths": torch.zeros(3, slots, dtype=torch.int64), "types": torch.zeros(3, slots, dtype=torch.int64)}
    out = {name: t.numpy() for name, t in tensors.items()}
    pos, seq = np.zeros(3, np.int64), np.zeros(3, np.int64)
    for i in range(12):  # past one cycle
        n = sched.fill(i, syms, slots, tensors)
        assert n == int((out["lengths"] > 0).sum())
        for c in range(3):
            for k in range(slots):
                length = int(out["lengths"][c, k])
                if not length:
                    assert not out["data"][c, k].any()
                    continue
                assert i * syms <= pos[c] < (i + 1) * syms
                if out["types"][c, k] == entry.IDLE:
                    assert length == 256
                    assert np.array_equal(out["data"][c, k, :256], (np.arange(256) + seq[c]) % 255)
                    seq[c] += 1
                else:
                    assert length == 1500 and any(np.array_equal(out["data"][c, k, :1500], p) for p in sched.pool)
                pos[c] += 64 + 4 * (32 + length + 4)
    assert (pos >= 12 * syms).all()


@pytest.mark.parametrize("name", ["slide_ms.loop", "idle_rows_pct.rx"])
def test_readers_none_on_empty_record(name):
    read = load_module(HERE / "metrics" / f"{name}.py").read
    assert read({}) is None


def test_reference_stands_alone():
    assert guard.reference_violations() == []
