"""The port as a package: it never imports JAX, its tables carry over from
the JAX receiver bit for bit, CPU tensors never reach a CUDA kernel, it
rejects configurations the JAX package mishandles silently, and
chip_smoke.py refuses to run without a CUDA device."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu.models.receiver import Receiver as JReceiver  # noqa: E402
from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.entry import BENCH_CONFIG, bank_entry, entry  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.tables import (  # noqa: E402
    JAX_ATTRIBUTES,
    numpy_tables_of,
    tables_from_numpy,
)
from gr4_packet_modem_tpu_torch.ops import _build  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas import costas_gains  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.costas_cuda import costas_track  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.fetch_cuda import fetch_regions  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.ldpc_cuda import ldpc_totals  # noqa: E402
from gr4_packet_modem_tpu_torch.ops.matched_cuda import matched_filter  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.device import kernel_route  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX = """
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ImportError("jax is blocked: " + name)
        return None

sys.meta_path.insert(0, _Block())
from gr4_packet_modem_tpu_torch.entry import entry
import gr4_packet_modem_tpu_torch.runtime.streaming
import gr4_packet_modem_tpu_torch.utils.cplx
fn, (x,) = entry("cpu")
acc, lens, data = fn(x)
assert acc.shape == (16,) and data.shape == (16, 256), (acc.shape, data.shape)
assert not acc.any()
assert "jax" not in sys.modules
print("no jax")
"""


def test_port_runs_without_jax():
    """A fresh interpreter in which importing JAX raises imports the port
    and runs the single-channel entry() step on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert "no jax" in out.stdout


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a tensor's values, for bit-for-bit comparison."""
    a = t.numpy()
    return np.ascontiguousarray(a).view(np.uint8)


@pytest.mark.parametrize("carrier", ["vv", "costas"])
def test_tables_from_jax_equal_own_tables_bit_for_bit(carrier):
    kw = dict(max_payload_len=1536, max_detections=24, freq_bins=4, payload_carrier=carrier)
    jrx = JReceiver(JConfig(**kw, acquisition_backend="fft", use_pallas=False))
    rx = Receiver(RxConfig(**kw), "cpu")
    carried = tables_from_numpy(numpy_tables_of(jrx))
    assert set(carried) == set(JAX_ATTRIBUTES)
    for name, t in carried.items():
        own = rx.get_buffer(name)
        assert own.dtype == t.dtype and own.shape == t.shape, name
        np.testing.assert_array_equal(_bits(own), _bits(t), err_msg=name)


def test_load_tables_and_reject_mismatch():
    cfg = RxConfig(max_payload_len=64, max_detections=4, freq_bins=1)
    jrx = JReceiver(JConfig(max_payload_len=64, max_detections=4, freq_bins=1))
    rx = Receiver(cfg, "cpu")
    carried = tables_from_numpy(numpy_tables_of(jrx))
    scaled = dict(carried, arm_taps=carried["arm_taps"] * 2)
    rx.load_tables(scaled)
    torch.testing.assert_close(rx.arm_taps, carried["arm_taps"] * 2, rtol=0, atol=0)
    rx.load_tables(carried)
    torch.testing.assert_close(rx.arm_taps, carried["arm_taps"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="ldpc_vidx"):
        rx.load_tables({"ldpc_vidx": carried["ldpc_vidx"].long()})
    bigger = tables_from_numpy(numpy_tables_of(JReceiver(JConfig(max_payload_len=128))))
    with pytest.raises(ValueError, match="crc_g_packed"):
        rx.load_tables({"crc_g_packed": bigger["crc_g_packed"]})


def test_cpu_tensors_never_launch_kernels():
    _build.reset_launch_counts()
    fn, (x,) = entry("cpu")
    fn(x)
    step, (xb,) = bank_entry("cpu", channels=2, block=1 << 14)
    assert step.__self__.acquirer.backend == "fused"  # K1's plain version on the CPU
    det, hdr, res, keep = step(xb)
    assert res.accepted.shape == (2 * BENCH_CONFIG.max_detections,)
    assert _build.launch_counts() == dict.fromkeys(_build.KERNELS, 0)


def test_chip_smoke_fails_without_cuda():
    assert not torch.cuda.is_available()
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize(
    "kw",
    [
        dict(payload_carrier="vv", max_payload_len=11),  # V&V with no block
        dict(acquisition_backend="conv_f16"),  # no such acquisition backend
        dict(payload_carrier="pll"),
        dict(max_payload_len=0),
    ],
)
def test_rxconfig_rejects(kw):
    with pytest.raises(ValueError):
        RxConfig(**kw)


def test_rxconfig_accepts_smallest_vv_payload():
    assert RxConfig(payload_carrier="vv", max_payload_len=12).max_payload_syms == 64


def test_kernel_route_has_no_fallback():
    cpu = torch.zeros(3)
    meta = torch.zeros(3, device="meta")
    assert kernel_route(cpu, cpu) == "plain"
    with pytest.raises(ValueError):
        kernel_route(meta)
    with pytest.raises(ValueError):
        kernel_route(cpu, meta)


@pytest.mark.parametrize(
    "call",
    [
        lambda: fetch_regions(torch.zeros(10), torch.zeros(2, dtype=torch.int64), 4),
        lambda: fetch_regions(torch.zeros(10, dtype=torch.complex64), torch.zeros(2, dtype=torch.int32), 4),
        lambda: fetch_regions(torch.zeros(10, dtype=torch.complex64), torch.zeros(2, dtype=torch.int64), 11),
        lambda: matched_filter(torch.zeros(2, 20), torch.zeros(3, 20), torch.zeros(2, 4), 4, 3),
        lambda: costas_track(torch.zeros(2, 8, dtype=torch.complex64), torch.zeros(3), torch.zeros(2)),
        lambda: ldpc_totals(torch.zeros(2, 128), torch.zeros(96, 5, dtype=torch.int64), torch.zeros(128, 3, dtype=torch.int32)),
        lambda: fetch_regions(torch.zeros(20, dtype=torch.complex64)[::2], torch.zeros(2, dtype=torch.int64), 4),
    ],
)
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_build_targets_hopper_with_exact_costas_gains():
    flags = _build._flags()
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any("fast_math" in f or "fast-math" in f for f in flags)
    defines = dict(f[2:].split("=") for f in flags if f.startswith("-DPM_COSTAS_"))
    names = ("K1A", "K2A", "K1B", "K2B", "K1C", "K2C")
    for n, g in zip(names, costas_gains()):
        assert float.fromhex(defines[f"PM_COSTAS_{n}"][:-1]) == float(np.float32(g))
    sources = {p.name for p in _build._sources()}
    assert {"fetch.cu", "matched.cu", "costas.cu", "ldpc.cu", "correlate.cu"} <= sources
    assert _build.library_path().parent == _build.BUILD_DIR
