"""Whole runs of the harness on the CPU at a tiny size (``run_cell`` with
the card's check skipped): a sound run is correct; a run with the timed
path broken underneath is not; a configuration, a traffic mix and a metric
added as new files and new manifest entries are picked up with no code
edit."""

import copy
import json

import numpy as np
import pytest
import torch

from h100_bench.run import applies, run_cell

SEED = 2**33 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _run(manifest, bench_dir, cell, hooks=None, seconds=1.5):
    return run_cell(manifest, cell, SEED, seconds, False, torch.device("cpu"), bench_dir=bench_dir,
                    hooks=hooks)[0]


@pytest.mark.parametrize("cell", ["vv64_dense", "vv8_stream"])
def test_sound_run_is_correct(manifest, bench_dir, cell):
    r = _run(manifest, bench_dir, cell)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    e2e = [m["name"] for m in manifest["end_to_end"] if applies(m, cell, set())]
    assert "setup_s" in e2e and len(e2e) >= 3
    assert all(r["metrics"][n]["value"] > 0 for n in e2e if n != "peak_mem_gib"), r["metrics"]  # no card, no peak


def _alter_byte(out):
    det, hdr, res, keep = out
    rows = res.accepted.nonzero().squeeze(1)
    res.data[rows[0], 7] ^= 0x5A
    return out


def _drop_half(out):
    det, hdr, res, keep = out
    res.accepted[res.accepted.shape[0] // 2 :] = False
    return out


def _stale():
    last = []

    def fault(out):  # every step returns the first step's results: its state never moves
        if not last:
            last.append(out)
        return last[0]

    return fault


RESIDENT_FAULTS = {"answer_altered": lambda: _alter_byte, "half_batch_left_out": lambda: _drop_half,
                   "state_unchanged": _stale}


@pytest.mark.parametrize("fault", sorted(RESIDENT_FAULTS))
def test_resident_fault_is_not_correct(manifest, bench_dir, fault):
    r = _run(manifest, bench_dir, "vv64_dense", {"fault": RESIDENT_FAULTS[fault]()})
    assert not r["correct"]


def _stream_fault(kind):
    def install(bank):
        if kind == "state_unchanged":
            step = bank._step

            def frozen(planes):  # the sliding buffer and suppression state never advance
                cur, busy = bank._cur, bank._busy
                out = step(planes)
                bank._cur, bank._busy = cur, busy
                return out

            bank._step = frozen
            return
        materialize = bank._materialize

        def broken(inflight):
            out = materialize(inflight)
            if kind == "answer_altered" and out:
                out[0].data = out[0].data.copy()
                out[0].data[3] ^= 0x01
            if kind == "half_batch_left_out":
                out = [p for p in out if p.channel < bank.channels // 2]
            return out

        bank._materialize = broken

    return install


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch_left_out", "state_unchanged"])
def test_stream_fault_is_not_correct(manifest, bench_dir, fault):
    r = _run(manifest, bench_dir, "vv8_stream", {"fault": _stream_fault(fault)})
    assert not r["correct"]


def test_new_config_traffic_and_metric_need_only_files(manifest, bench_dir):
    cfg = json.loads((bench_dir / "configs" / "rx_vv.json").read_text())
    cfg["rx"]["acquisition_backend"] = "fft"
    (bench_dir / "configs" / "rx_vv_fft.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "dense1500_64ch.json").read_text())
    mix.update(channels=3, noise=0.04)
    (bench_dir / "traffic" / "dense1500_3ch.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "steps_per_s.py").write_text(
        'LAYER, UNIT, SOURCE, MOVES = "end to end", "1/s", "host_clock", None\n\n\n'
        'def read(rec):\n    return rec["steps"] / rec["window_s"]\n')
    m = copy.deepcopy(manifest)
    m["configs"].append({"name": "rx_vv_fft", "source": cfg["source"], "file": "x", "reduced": [], "why": "x"})
    m["workloads"].append({"name": "vvfft3", "config": "rx_vv_fft", "traffic": "dense1500_3ch", "chips": 1,
                           "why": "x"})
    next(e for e in m["end_to_end"] if e["name"] == "rx_sps")["workloads"].append("vvfft3")
    m["end_to_end"].append({"name": "steps_per_s", "unit": "1/s", "better": "higher", "bound": 0.05,
                            "source": "host_clock", "workloads": ["vvfft3"]})
    r = _run(m, bench_dir, "vvfft3")
    assert r["correct"] and r["metrics"]["steps_per_s"]["value"] > 0
    assert "rx_sps" in r["metrics"] and np.isfinite(r["metrics"]["rx_sps"]["value"])


def _four_channels(bench_dir):
    """The staged 4-card cell's mix at four channels, one a rank."""
    mix = json.loads((bench_dir / "traffic" / "stream_int8_64ch.json").read_text())
    mix["channels"] = 4
    (bench_dir / "traffic" / "stream_int8_64ch.json").write_text(json.dumps(mix))


def _exchange_left_out(bank):
    gather = bank._gather_wire

    def local_only(packed):  # the collective runs, but rank 0 keeps only its own cell's wire
        out = gather(packed).clone()
        out[packed.numel():] = 0
        return out

    bank._gather_wire = local_only


@pytest.mark.parametrize("fault", [None, "exchange_left_out"])
def test_sharded_four_ranks(manifest, bench_dir, fault):
    hooks = {"fault": _exchange_left_out} if fault else None
    _four_channels(bench_dir)
    r = _run(manifest, bench_dir, "vv64_stream_4card", hooks, seconds=2.0)
    assert r["device"]["count"] == 4
    assert r["correct"] == (fault is None), r["checks"]
