"""The port's examples (``gr4_packet_modem_tpu_torch/examples/``) against
the JAX examples (``examples/*.py``), each run in this process: the port's
through ``run(["--device", "cpu"], echo=...)``, the JAX example as a
script by ``runpy`` with its printed lines captured (its compile cache
off), on the CPU devices of tests/conftest.py.

Held to, one case an example:

- crc, pack_bits, qpsk_modulator, minimal_flowgraph, stream_pdu_domains,
  packet_to_stream, header_formatter, header_roundtrip, packet_ingress:
  the same printed lines;
- messages: the same lines with the wall times masked;
- pfb_arb_resampler: the measured tone within 1e-6 of JAX's;
- syncword_detection: the same start, the frequency within 5e-4
  rad/sample, the amplitude within 0.05 and Es/N0 within 1.5 dB of JAX's
  (the noise comes from a torch generator, not from jax.random);
- loopback, streaming_blocks, tun_loopback (demo): the same payloads,
  byte-exact, at the same sample indices where the example prints them;
- per_sweep: each point within 3 binomial sigma of JAX's (sigma from the
  mean of the two PERs over 32 packets, at least 1/32), the ends exact.

And ``--device cuda`` without a card raises, for one example of each kind
(host-only, tensor ops, receiving, mesh). The mesh examples are held in
tests/test_torch_examples_sharded.py.
"""

import contextlib
import importlib
import io
import os
import re
import runpy
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_example(name: str, monkeypatch, run_name: str = "__main__") -> tuple[list[str], dict]:
    """Run examples/<name>.py here; returns its printed lines and its
    globals."""
    path = os.path.join(ROOT, "examples", f"{name}.py")
    monkeypatch.setenv("JAX_CACHE_DIR", "")  # no persistent compile cache
    monkeypatch.setattr(sys, "argv", [path])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        g = runpy.run_path(path, run_name=run_name)
    return buf.getvalue().splitlines(), g


def port_example(name: str, *argv: str) -> tuple[list[str], dict]:
    mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.examples.{name}")
    lines = []
    res = mod.run(["--device", "cpu", *argv], echo=lines.append)
    return "\n".join(lines).splitlines(), res


SAME_LINES = [
    "crc", "pack_bits", "qpsk_modulator", "minimal_flowgraph", "stream_pdu_domains",
    "packet_to_stream", "header_formatter", "header_roundtrip", "packet_ingress",
]


@pytest.mark.parametrize("name", SAME_LINES)
def test_same_printed_lines(name, monkeypatch):
    want, _ = jax_example(name, monkeypatch)
    got, _ = port_example(name)
    assert want and got == want


def test_messages_same_lines_times_masked(monkeypatch):
    """What the wall clock decides is masked: the durations, how many
    strobe messages landed in the 0.22 s window, and the rate reports
    (the probe reports only once 0.2 s have passed, which the 20 packets
    at 0.01 s reach or not by the host's load)."""
    rate = re.compile(r"rate_now=[\d,]+ items/s rate_avg=[\d,]+$")

    def mask(lines):
        return [re.sub(r"stored \d+ ", "stored <n> ", re.sub(r"in \d+\.\d+s$", "in <t>s", ln))
                for ln in lines if not rate.match(ln)]

    want, _ = jax_example("messages", monkeypatch)
    got, res = port_example("messages")
    assert mask(got) == mask(want) and len(got) >= 4
    assert len([ln for ln in got if rate.match(ln)]) == len(res["reports"])
    assert 2 <= res["stored"] <= 5
    assert res["pulled"] == [42] * 5 and res["sent"] == 20 * 256 and res["in_flight"] == 0


def test_pfb_arb_resampler_tone(monkeypatch):
    _, g = jax_example("pfb_arb_resampler", monkeypatch)
    _, res = port_example("pfb_arb_resampler")
    assert abs(res["measured"] - g["f_meas"]) < 1e-6
    assert res["expected"] == g["expect"]


def test_syncword_detection(monkeypatch):
    _, g = jax_example("syncword_detection", monkeypatch)
    det, i = g["det"], g["i"]
    _, res = port_example("syncword_detection")
    assert res["start"] == int(np.asarray(det.index)[i]) - g["rx"].front_pad == 3000
    assert abs(res["freq"] - float(np.asarray(det.freq)[i])) < 5e-4
    assert abs(res["amp"] - float(np.asarray(det.amplitude)[i])) < 0.05
    assert abs(res["esn0_db"] - float(np.asarray(det.esn0_db)[i])) < 1.5


def test_loopback(monkeypatch):
    want, g = jax_example("loopback", monkeypatch)
    res = g["res"]
    acc, lens, data = (np.asarray(a) for a in (res.accepted, res.lengths, res.data))
    jax_decoded = [bytes(data[i, : lens[i]]) for i in np.nonzero(acc)[0]]
    got, res = port_example("loopback")
    assert res["decoded"] == jax_decoded == res["sent"]
    assert got == want


def test_streaming_blocks(monkeypatch):
    _, g = jax_example("streaming_blocks", monkeypatch)
    _, res = port_example("streaming_blocks")
    key = [(p.data.tobytes(), p.index) for p in g["decoded"]]
    assert [(p.data.tobytes(), p.index) for p in res["decoded"]] == key
    assert [k[0] for k in key] == [p.tobytes() for p in res["sent"]]


def test_tun_loopback_demo(monkeypatch):
    _, g = jax_example("tun_loopback", monkeypatch, run_name="tun_loopback_jax")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert g["run_demo"](0.05, 4) == 0
    pat = re.compile(r"packet at (\d+): (\d+) B .* byte-exact=(\w+)")
    want = [pat.match(ln).groups() for ln in buf.getvalue().splitlines() if pat.match(ln)]
    lines, res = port_example("tun_loopback")
    got = [pat.match(ln).groups() for ln in lines if pat.match(ln)]
    assert got == want and len(got) == 4 and all(m[2] == "True" for m in got)
    assert res["rc"] == 0 and [p.data.tobytes() for p in res["decoded"]] == res["sent"]
    assert "demo loopback: 4/4 IP packets through the modem" in lines


def test_per_sweep(monkeypatch):
    def rows(lines):
        return [tuple(map(float, ln.split())) for ln in lines[1:]]

    want, _ = jax_example("per_sweep", monkeypatch)
    got, res = port_example("per_sweep")
    assert got[0] == want[0] == "Es/N0[dB]  PER"
    a, b = rows(want), rows(got)
    assert [e for e, _ in a] == [e for e, _ in b] == [e for e, _ in res["rows"]]
    assert a[0][1] == b[0][1] == 1.0 and a[-1][1] == b[-1][1] == 0.0
    for (esn0, pj), (_, pt) in zip(a, b):
        mean = (pj + pt) / 2
        sigma = max(np.sqrt(mean * (1 - mean) / 32), 1 / 32)
        assert abs(pj - pt) <= 3 * sigma, (esn0, pj, pt)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", ["packet_to_stream", "crc", "loopback", "sharded_bank"])
def test_cuda_without_a_card_raises(name):
    mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        mod.run(["--device", "cuda"], echo=lambda *_: None)


def test_every_jax_example_has_a_port():
    """One module a JAX example, under its file name, with ``run`` and
    ``main``."""
    from gr4_packet_modem_tpu_torch.examples import EXAMPLES

    jax_names = sorted(f[:-3] for f in os.listdir(os.path.join(ROOT, "examples")) if f.endswith(".py"))
    assert sorted(EXAMPLES) == jax_names
    for name in EXAMPLES:
        mod = importlib.import_module(f"gr4_packet_modem_tpu_torch.examples.{name}")
        assert callable(mod.run) and callable(mod.main), name
