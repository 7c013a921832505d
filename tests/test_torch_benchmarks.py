"""The port's measurement programs (``gr4_packet_modem_tpu_torch/
benchmarks/``) against the JAX programs (``benchmarks/*.py``) on the CPU.

The port's run in this process through ``run(argv, device="cpu",
echo=False)``; the JAX program as a script by ``runpy`` with its printed
JSON lines captured (its compile cache off), on the CPU devices of
tests/conftest.py, at the same small command lines, both harnesses'
``time_fn`` cut to two timed calls. ``benchmark_bank_scaling``
measures every device count up to the device total, so its JAX program
runs in a subprocess at one CPU device, beside the port's world of one
(gloo), while the port runs.

Held to: the port's ``tiled_burst_signal`` within 1e-5 of the JAX one with
the same complete-burst count; each program's record with the JAX
program's keys, metric name and every non-timing field equal (``block``,
``channels``, ``backend``, ``batch``, ``decoded_frac``, ``decoded`` and
``expected``, the scaling records' ``devices`` and ``efficiency``), its
rate above 0; the samples a call the transmitter and transceiver programs
count equal to the JAX programs' and to what the port's transmitter emits.
The syncword program with the ``conv``, ``conv_bf16`` and ``fused_bf16``
backends finds the JAX program's detections, and asking for a card where
there is none raises.
"""

import contextlib
import importlib
import io
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.utils import constants as JC  # noqa: E402
from gr4_packet_modem_tpu_torch.benchmarks import BENCHMARKS  # noqa: E402
from gr4_packet_modem_tpu_torch.benchmarks import common  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = {"value", "vs_baseline", "compile_s", "samples_per_sec", "per_chip"}


def jax_program(name: str, argv: list[str], monkeypatch) -> list[dict]:
    """Run benchmarks/<name>.py here; returns its printed JSON records."""
    path = os.path.join(ROOT, "benchmarks", f"{name}.py")
    monkeypatch.setenv("JAX_CACHE_DIR", "")
    monkeypatch.setattr(sys, "argv", [path, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(path, run_name="__main__")
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


def port_program(name: str, argv: list[str]) -> dict:
    mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.benchmarks.{name}")
    return mod.run(argv, device="cpu", echo=False)


@pytest.fixture
def two_timed_calls(monkeypatch):
    """Both harnesses' timers at two timed calls a program: the comparison
    reads no time, and on the CPU a receive runs the plain Costas loop,
    about a second a call."""
    import benchmarks.common as jax_common

    def patch(module, timer):
        monkeypatch.setattr(module, "time_fn", lambda fn, *a, **kw: timer(fn, *a, **{**kw, "iters": 2}))

    patch(jax_common, jax_common.time_fn)
    for name in BENCHMARKS:
        mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.benchmarks.{name}")
        if hasattr(mod, "time_fn"):
            patch(mod, common.time_fn)


def same_record(got: dict, want: dict) -> None:
    """Same keys in the same order, every non-timing field equal, both
    rates above 0."""
    assert list(got) == list(want)
    assert {k: v for k, v in got.items() if k not in TIMING} == {
        k: v for k, v in want.items() if k not in TIMING
    }
    assert got["value"] > 0 and want["value"] > 0


@pytest.mark.parametrize("payload_len,num_packets,total,max_len", [
    (1500, 12, 1 << 16, 1536),  # the receiver and syncword programs' stimulus, cut
    (200, 12, 1 << 16, 256),  # benchmark_bank_scaling's
    (300, 5, 50_000, 512),  # a block that is no whole number of tiles
])
def test_tiled_burst_signal(payload_len, num_packets, total, max_len):
    from benchmarks.common import tiled_burst_signal as jax_tiled

    want, want_pkts = jax_tiled(payload_len, num_packets, total, max_len, seed=3)
    got, pkts = common.tiled_burst_signal(payload_len, num_packets, total, max_len, seed=3, device="cpu")
    assert got.dtype == np.complex64 and got.shape == want.shape == (total,)
    assert np.max(np.abs(got - np.asarray(want))) <= 1e-5
    assert pkts == want_pkts > 0


def test_time_fn_calls():
    """The first call, the warm-up calls, then the timed ones."""
    calls = []
    dt, first_s = common.time_fn(calls.append, 7, iters=3, warmup=2, device="cpu")
    assert calls == [7] * 6 and dt >= 0 and first_s >= 0


def test_report_matches_jax_report(capsys):
    from benchmarks.common import report as jax_report

    want = jax_report("m", 123456.789, "samples/s", 1e6, block=4, decoded_frac=1.0)
    want_line = capsys.readouterr().out
    got = common.report("m", 123456.789, "samples/s", 1e6, block=4, decoded_frac=1.0)
    assert got == want and capsys.readouterr().out == want_line
    assert common.report("m", 1.0, "u", None, echo=False) == {"metric": "m", "value": 1.0, "unit": "u"}
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("name,argv", [
    ("benchmark_packet_receiver", ["2", "2", "16"]),
    ("benchmark_syncword_detection", ["2", "fft", "16"]),
    ("benchmark_syncword_detection", ["1", "fused", "15"]),
    ("benchmark_packet_transceiver", ["2", "2"]),
    ("benchmark_packet_transmitter_pdu", ["burst", "2"]),
    ("benchmark_packet_transmitter_pdu", ["stream", "2"]),
])
def test_program_matches_jax(name, argv, monkeypatch, two_timed_calls):
    (want,) = jax_program(name, argv, monkeypatch)
    got = port_program(name, argv)
    same_record(got, want)
    if "decoded_frac" in got:
        assert got["decoded_frac"] == 1.0
    if "decoded" in got:
        assert got["decoded"] == got["expected"] == int(argv[1])


@pytest.mark.parametrize("mode", ["burst", "stream"])
def test_tx_samples_per_call(mode):
    """The samples the TX program counts a call: the JAX program's formula,
    and what the port's transmitter emits."""
    from gr4_packet_modem_tpu_torch.benchmarks.benchmark_packet_transmitter_pdu import tx_step

    fn, packets, n = tx_step(mode, 3, "cpu")
    syms = JC.stream_symbols(1500) if mode == "stream" else JC.burst_symbols(1500)
    assert n == 3 * syms * 4
    samples, lens = fn(packets)
    assert (samples.shape[0] if mode == "stream" else int(lens.sum())) == n


def test_transceiver_samples_per_call():
    from gr4_packet_modem_tpu_torch.entry import transceiver_entry

    fn, _ = transceiver_entry("cpu", 2, 3)
    assert fn.total == 3 * 24912 == 3 * 4 * JC.burst_symbols(1500)


def test_bank_scaling_matches_jax():
    """JAX at one CPU device in a subprocess, the port on a gloo world of
    one started by the program: one record each, devices 1, efficiency 1."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PM_PLATFORM="cpu", JAX_CACHE_DIR="",
               XLA_FLAGS="--xla_force_host_platform_device_count=1")
    jax_proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "benchmarks", "benchmark_bank_scaling.py"), "2", "16"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        got = port_program("benchmark_bank_scaling", ["2", "16"])["records"]
    finally:
        out, err = jax_proc.communicate(timeout=300)
    assert jax_proc.returncode == 0, err[-2000:]
    want = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [list(r) for r in got] == [list(r) for r in want]
    assert [(r["devices"], r["efficiency"]) for r in got] == [
        (r["devices"], r["efficiency"]) for r in want] == [(1, 1.0)]
    assert got[0]["samples_per_sec"] > 0 and got[0]["per_chip"] == got[0]["samples_per_sec"]
    import torch.distributed as dist

    assert not dist.is_initialized()  # the program's own world is gone


@pytest.mark.parametrize("backend", ["conv", "conv_bf16", "fused_bf16"])
def test_syncword_unported_backends_raise(backend, monkeypatch):
    """The backends the port once refused, now ported: the port's program
    against the JAX program at 2 bins on a 2**16 block, the same record
    and the same detections (valid, index, freq_bin) from the acquisition
    each times, both harnesses cut to two timed calls."""
    import benchmarks.common as jax_common
    from gr4_packet_modem_tpu_torch.benchmarks import benchmark_syncword_detection as port_mod

    seen = {}

    def capture(module, key):
        timer = module.time_fn

        def time_fn(step, *args, **kw):
            seen[key] = step(*args)
            return timer(step, *args, **{**kw, "iters": 2})

        monkeypatch.setattr(module, "time_fn", time_fn)

    capture(jax_common, "jax")
    capture(port_mod, "port")
    argv = ["2", backend, "16"]
    (want,) = jax_program("benchmark_syncword_detection", argv, monkeypatch)
    got = port_program("benchmark_syncword_detection", argv)
    same_record(got, want)
    assert got["backend"] == backend
    j, p = seen["jax"], seen["port"]
    v = np.asarray(j.valid)
    assert v.sum() >= 2
    np.testing.assert_array_equal(p.valid.numpy(), v)
    for field in ("index", "freq_bin"):
        np.testing.assert_array_equal(getattr(p, field).numpy()[v], np.asarray(getattr(j, field))[v])


@pytest.mark.parametrize("name", [*BENCHMARKS, "bench"])
def test_cuda_without_card_raises(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    prefix = "gr4_packet_modem_tpu_torch" + ("" if name == "bench" else ".benchmarks")
    mod = importlib.import_module(f"{prefix}.{name}")
    with pytest.raises(RuntimeError, match="cuda"):
        mod.run([], echo=False)
    with pytest.raises(RuntimeError, match="cuda"):
        mod.run(["--device", "cuda"], device="cpu", echo=False)
