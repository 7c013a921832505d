"""The port stands alone: it imports nothing of the JAX package, and its own
copies of the JAX package's numpy modules and bench stimulus agree with
the originals bit for bit.

(a) runs in a fresh interpreter in which importing ``gr4_packet_modem_tpu``
(or JAX) raises; (b) and (c) compare the copies with the JAX package's
modules and ``tests/reference_impl.py``, which only the tests import: the
numpy modules and the channel's resampler prototype bit for bit, the ZMQ
publisher by what it sends and when it refuses.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import reference_impl as ref  # noqa: E402
from gr4_packet_modem_tpu.io import zmq_pub as j_zmq_pub  # noqa: E402
from gr4_packet_modem_tpu.models import channel as j_channel  # noqa: E402
from gr4_packet_modem_tpu.utils import constants as j_constants  # noqa: E402
from gr4_packet_modem_tpu.utils import firdes as j_firdes  # noqa: E402
from gr4_packet_modem_tpu.utils import lfsr as j_lfsr  # noqa: E402
from gr4_packet_modem_tpu_torch.io import zmq_pub  # noqa: E402
from gr4_packet_modem_tpu_torch.models import channel  # noqa: E402
from gr4_packet_modem_tpu_torch.utils import constants, firdes, lfsr, stimulus  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = """
import importlib, pkgutil, sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("gr4_packet_modem_tpu", "jax", "jaxlib"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
import gr4_packet_modem_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from gr4_packet_modem_tpu_torch.examples import EXAMPLES
missing = sorted(set(EXAMPLES) - {n.rsplit(".", 1)[-1] for n in names if ".examples." in n})
assert len(EXAMPLES) == 19 and not missing, missing
import chip_smoke
samples, expected, starts = chip_smoke.bench_signal(1 << 15, 2)
assert samples.shape == (2, 1 << 15) and samples.dtype.name == "complex64"
assert len(expected) == 1 and list(starts) == [0], (len(expected), starts)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("gr4_packet_modem_tpu", "jax"))
assert not leaked, leaked
print("standalone", len(names))
"""


def test_port_imports_nothing_of_the_jax_package():
    """(a) Every module of the port (the 19 examples' among them), and
    chip_smoke with its stimulus, in an interpreter that refuses the JAX
    package and JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "standalone" in out.stdout
    assert int(out.stdout.split()[-1]) >= 20  # the port's modules were all found


def _bits(a) -> bytes:
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype.str.encode() + str(a.shape).encode() + a.tobytes()


def _public_constants(mod):
    return {
        k: v for k, v in vars(mod).items()
        if k.isupper() and not k.startswith("_")
    }


def test_constants_equal_bit_for_bit():
    """(b) Every protocol constant, and the helpers that compute from them."""
    mine, theirs = _public_constants(constants), _public_constants(j_constants)
    assert set(mine) == set(theirs)
    for k in theirs:
        assert _bits(mine[k]) == _bits(theirs[k]), k
    assert list(constants.PacketType) == list(j_constants.PacketType)
    assert list(constants.Constellation) == list(j_constants.Constellation)
    for n in (0, 1, 64, 1500, 65535):
        assert _bits(constants.format_header(n, 1)) == _bits(j_constants.format_header(n, 1))
        for f in ("num_data_symbols", "burst_symbols", "stream_symbols"):
            assert getattr(constants, f)(n) == getattr(j_constants, f)(n)


@pytest.mark.parametrize("sps", [2, 4, 8])
def test_firdes_equal_bit_for_bit(sps):
    """(b) The golden taps (sps 4) and the designed ones (other sps)."""
    assert _bits(firdes.tx_rrc_taps(sps)) == _bits(j_firdes.tx_rrc_taps(sps))
    taps, norm = firdes.rx_rrc_taps(sps)
    j_taps, j_norm = j_firdes.rx_rrc_taps(sps)
    assert _bits(taps) == _bits(j_taps) and norm == j_norm
    for arms in (16, 32):
        assert _bits(firdes.rx_pfb_taps(sps, arms)) == _bits(j_firdes.rx_pfb_taps(sps, arms))
    rrc = firdes.root_raised_cosine(1.0, float(sps), 1.0, 0.35, 11 * sps)
    assert _bits(rrc) == _bits(j_firdes.root_raised_cosine(1.0, float(sps), 1.0, 0.35, 11 * sps))
    assert _bits(firdes.polyphase(rrc, sps)) == _bits(j_firdes.polyphase(rrc, sps))


@pytest.mark.parametrize("nbits", [1, 256, 12_376])
def test_lfsr_equal_bit_for_bit(nbits):
    """(b) The scrambler keystream and the ramp-down GLFSR."""
    assert _bits(lfsr.additive_scrambler_keystream(nbits)) == _bits(
        j_lfsr.additive_scrambler_keystream(nbits))
    assert _bits(lfsr.glfsr_bits(nbits)) == _bits(j_lfsr.glfsr_bits(nbits))
    assert _bits(lfsr.GLFSR_POLYNOMIAL_MASKS) == _bits(j_lfsr.GLFSR_POLYNOMIAL_MASKS)


@pytest.mark.parametrize("length,index,seed", [(0, 0, 0), (1, 3, 1), (64, 11, 2), (200, 0, 3), (1500, 7, 4)])
def test_stimulus_equals_reference_impl(length, index, seed):
    """(c) Bursts and coded headers against the tests' sequential
    transmitter, for several payloads and packet indices."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 256, length, dtype=np.uint8)
    assert _bits(stimulus.burst_samples(payload, packet_index=index)) == _bits(
        ref.burst_samples(payload, packet_index=index))
    header = rng.integers(0, 256, 4, dtype=np.uint8)
    assert _bits(stimulus.ldpc_encode_bytes(header)) == _bits(ref.ldpc_encode_bytes(header))
    assert _bits(stimulus.frame_bytes(payload, 1)) == _bits(ref.frame_bytes(payload, 1))


@pytest.mark.parametrize("arms,taps_per_arm", [(32, 40), (16, 24)])
def test_pfb_arb_taps_equal_bit_for_bit(arms, taps_per_arm):
    """(b) The resampler's prototype (scipy's remez on both sides)."""
    assert _bits(channel.pfb_arb_taps(arms, taps_per_arm)) == _bits(j_channel.pfb_arb_taps(arms, taps_per_arm))


class _Socket:
    def __init__(self):
        self.sent = []

    def send(self, data):
        self.sent.append(data)


@pytest.mark.parametrize("have", [True, False])
def test_zmq_pub_behaves_as_the_original(monkeypatch, have):
    """(b) ``have_zmq`` agrees; a sink sends each PDU as its contiguous
    bytes (a strided complex view included); without pyzmq both refuse to
    build a sink."""
    assert zmq_pub.have_zmq() == j_zmq_pub.have_zmq()
    if not have:
        monkeypatch.setattr(zmq_pub, "_ZMQ", False)
        monkeypatch.setattr(j_zmq_pub, "_ZMQ", False)
        for mod in (zmq_pub, j_zmq_pub):
            with pytest.raises(RuntimeError, match="pyzmq not available"):
                mod.ZmqPduPubSink("tcp://127.0.0.1:1")
        return
    pdus = [np.arange(12, dtype=np.float32).view(np.complex64)[::2], np.arange(5, dtype=np.uint8)]
    sent = []
    for mod in (zmq_pub, j_zmq_pub):
        sink = mod.ZmqPduPubSink.__new__(mod.ZmqPduPubSink)
        sink._sock = _Socket()
        for p in pdus:
            sink.send(p)
        sent.append(sink._sock.sent)
    assert sent[0] == sent[1] and all(isinstance(m, bytes) for m in sent[0])
