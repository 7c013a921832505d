"""The port's ``bench`` (``gr4_packet_modem_tpu_torch/bench.py``) against
the root ``bench.py`` on the CPU, at ``BENCH_CHANNELS=2 BENCH_BLOCK=65536
BENCH_ITERS=2 BENCH_BANK_CHANNELS=2`` (2**18-sample blocks for the Costas
carrier).

``bench.py`` builds its sharded bank's mesh over every JAX device, so it
runs in a subprocess at one CPU device (the 1 x 1 mesh the port's world of
one gives); the three cases' JAX runs go one after another in the
background from the module's first test on, while the port's
``bench.run(device="cpu")`` runs in this process.

Held to, for the V&V carrier with fused acquisition and the Costas
carrier with fft acquisition: the same keys in the same
order, every non-timing field equal (``max_detections``,
``decoded_packet_frac``, every ``*_parity_ok``, ``*_expected_pkts``,
``*_decoded_pkts``, ``*_budget``, ``sustained_overflow_blocks``,
``sharded_mesh``, the geometry and knobs), each gate holding, and each
rate above 0 exactly when its gate holds. With ``BENCH_BUDGET=1`` (one
result slot a channel a block) every gate fails in both programs and every
sustained rate is 0.0.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"BENCH_CHANNELS": "2", "BENCH_BLOCK": "65536", "BENCH_ITERS": "2", "BENCH_BANK_CHANNELS": "2"}
# V&V with bench.py's default fused acquisition, Costas with fft: both
# acquisition backends. The Costas case runs 2**18-sample blocks: the
# plain Costas loop (the CPU's route) costs about a second a block
# whatever its rows, and the streaming runs feed whole 12-burst tiles
# whatever the block, so a larger block means a quarter of the loops
CASES = {
    "vv": {"BENCH_CARRIER": "vv", "BENCH_ACQ": "fused"},
    "costas": {"BENCH_CARRIER": "costas", "BENCH_ACQ": "fft", "BENCH_BLOCK": str(1 << 18)},
    "budget1": {"BENCH_CARRIER": "vv", "BENCH_ACQ": "fft", "BENCH_BUDGET": "1"},
}
GATES = {  # parity flag -> its rate
    "sustained_parity_ok": "sustained_stream_sps",
    "bank_sustained_parity_ok": "bank_sustained_sps",
    "sharded_parity_ok": "sharded_bank_sustained_sps",
}
TIMING = {"value", "vs_baseline", "compile_s", "device", *GATES.values()}


def timing(key: str) -> bool:
    return key in TIMING or key.endswith("_ms_per_block")


@pytest.fixture(scope="module")
def jax_runs():
    """bench.py once a case, one after another in the background (they
    run while the port runs here); ``get(case)`` waits for that case's
    record."""

    def jax_bench(knobs: dict) -> subprocess.CompletedProcess:
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "PM_PLATFORM": "cpu", "JAX_CACHE_DIR": "",
               "XLA_FLAGS": "--xla_force_host_platform_device_count=1", **SMALL, **knobs}
        return subprocess.run([sys.executable, os.path.join(ROOT, "bench.py")], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=600)

    with ThreadPoolExecutor(1) as pool:
        runs = {case: pool.submit(jax_bench, knobs) for case, knobs in CASES.items()}

        def get(case: str) -> dict:
            p = runs[case].result()
            assert p.returncode == 0, p.stderr[-2000:]
            return json.loads(p.stdout.strip().splitlines()[-1])

        yield get


def port_bench(case: str, monkeypatch) -> dict:
    from gr4_packet_modem_tpu_torch import bench

    for k, v in {**SMALL, **CASES[case]}.items():
        monkeypatch.setenv(k, v)
    return bench.run(device="cpu", echo=False)


def same_fields(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if not timing(k)} == {
        k: v for k, v in want.items() if not timing(k)
    }
    for r in (got, want):
        assert r["value"] > 0 and r["decoded_packet_frac"] == 1.0
        for gate, rate in GATES.items():
            assert (r[rate] > 0) == r[gate], (gate, r[rate])


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_bench_matches_jax(carrier, jax_runs, monkeypatch):
    got = port_bench(carrier, monkeypatch)
    want = jax_runs(carrier)
    same_fields(got, want)
    assert got["carrier"] == carrier and got["acq_backend"] == CASES[carrier]["BENCH_ACQ"]
    assert all(got[g] for g in GATES), {g: got[g] for g in GATES}
    assert got["sharded_mesh"] == [1, 1] and got["sustained_overflow_blocks"] == 0
    assert got["sustained_decoded_pkts"] == got["sustained_expected_pkts"] > 0


def test_bench_budget_overflow_fails_every_gate(jax_runs, monkeypatch):
    got = port_bench("budget1", monkeypatch)
    want = jax_runs("budget1")
    same_fields(got, want)
    for r in (got, want):
        assert r["sustained_budget"] == 1 and r["bank_budget"] == r["sharded_budget"] == 2
        assert not any(r[g] for g in GATES)
        assert all(r[rate] == 0.0 for rate in GATES.values())


def test_bench_rejects_positional_arguments():
    from gr4_packet_modem_tpu_torch import bench

    with pytest.raises(SystemExit, match="no positional"):
        bench.run(["64"], device="cpu", echo=False)
