"""The receiver's and the transmitter's constant tables, and carrying them
across from the JAX package.

The modem has no learned weights. Its parameters are constant tables that
the JAX ``Receiver`` and ``Transmitter`` hold as numpy arrays; the port
builds the same tables itself (:func:`receiver_tables`,
:func:`transmitter_tables`) and holds them as buffers of its
``nn.Module``s. :func:`tables_from_numpy` turns a dict of such numpy arrays
into tensors, so ``Receiver.load_tables`` and ``Transmitter.load_tables``
can compute from exactly the JAX objects' tables. ``JAX_ATTRIBUTES`` and
``TX_JAX_ATTRIBUTES`` name where each table lives on a JAX ``Receiver`` and
``Transmitter`` (:func:`numpy_tables_of` reads them without importing JAX;
the transmitter's LDPC generator is the JAX package's
``ops.ldpc.load_generator()``, not an attribute).
"""

from __future__ import annotations

import numpy as np
import torch

from functools import lru_cache

from ..utils import constants as C
from ..utils.firdes import rx_pfb_taps, tx_rrc_taps
from ..utils.lfsr import glfsr_bits
from ..utils.stimulus import burst_ramps

from ..ops.crc import crc32_tables
from ..ops.ldpc import decoder_tables, load_generator

__all__ = [
    "JAX_ATTRIBUTES", "TX_JAX_ATTRIBUTES", "receiver_tables", "transmitter_tables",
    "tables_from_numpy", "numpy_tables_of",
]

# port table name -> attribute path on a gr4_packet_modem_tpu Receiver
JAX_ATTRIBUTES = {
    "arm_taps": "_arm_taps",
    "sync_bipolar": "_sync_bipolar",
    "llr_scale": "_llr_scale",
    "acquirer.replicas": "acquirer.replicas",
    "acquirer.noise_filter": "acquirer._noise_filter",
    "acquirer.noise_gain": "acquirer._noise_gain",
    "acquirer.self_corr": "acquirer.self_corr",
    "acquirer.conv_kernel": "acquirer._conv_kernel",
    "ldpc_vidx": "_decoder._vidx",
    "ldpc_vmask": "_decoder._vmask",
    "ldpc_h": "_decoder._h",
    "crc_g_packed": "_crc._g_packed",
    "crc_init_lut": "_crc._init_lut",
    "crc_final_xor": "_crc._final_xor",
}


def receiver_tables(
    sps: int, num_pfb_arms: int, max_payload_len: int
) -> dict[str, np.ndarray]:
    """The receiver's own tables of ``JAX_ATTRIBUTES`` (the ``acquirer.*``
    ones come from ``ops/acquire.py::acquirer_tables``), built with the JAX
    package's recipes: polyphase arm taps ``[A, K]`` (arm j, tap k =
    pfb[j + A*k]), the syncword's bipolar wipe-off, the LLR scale
    2/sigma^2, the LDPC decoder's and the CRC-32 engine's tables."""
    pfb = rx_pfb_taps(sps, num_pfb_arms)
    k = pfb.size // num_pfb_arms
    out = {
        "arm_taps": pfb.reshape(k, num_pfb_arms).T.astype(np.float32).copy(),
        "sync_bipolar": np.where(np.asarray(C.SYNCWORD) != 0, -1.0, 1.0).astype(
            np.float32
        ),
        "llr_scale": np.float32(2.0 / C.LLR_NOISE_SIGMA**2),
    }
    out.update({f"ldpc_{n}": v for n, v in decoder_tables().items()})
    out.update({f"crc_{n}": v for n, v in crc32_tables(max_payload_len).items()})
    return out


# port table name -> attribute path on a gr4_packet_modem_tpu Transmitter
TX_JAX_ATTRIBUTES = {
    "taps": "taps",
    "lead_ramp": "lead_ramp",
    "trail_ramp": "trail_ramp",
    "ramp_bits_packed": "_ramp_bits_packed",
    "sync_syms": "_sync_syms",
    "qpsk": "_qpsk",
    "crc_g_packed": "_crc._g_packed",
    "crc_init_lut": "_crc._init_lut",
    "crc_final_xor": "_crc._final_xor",
}


@lru_cache(maxsize=4)
def _ramp_bits_packed(max_packets: int) -> np.ndarray:
    """The ramp-down GLFSR bits, 18 a packet packed into one uint32 word
    (bit i of word p = sequence bit 18p + i)."""
    rb = glfsr_bits(C.RAMP_DOWN_BITS * max_packets).reshape(max_packets, C.RAMP_DOWN_BITS)
    shifts = np.arange(C.RAMP_DOWN_BITS, dtype=np.uint32)[None, :]
    packed = (rb.astype(np.uint32) << shifts).sum(axis=1, dtype=np.uint32)
    packed.flags.writeable = False
    return packed


def transmitter_tables(sps: int, max_payload_len: int, max_packets_glfsr: int) -> dict[str, np.ndarray]:
    """The transmitter's tables of ``TX_JAX_ATTRIBUTES`` built with the JAX
    package's recipes (TX RRC taps, burst ramps, packed ramp-down bits,
    syncword BPSK symbols, QPSK points, CRC-32 engine), plus
    ``ldpc_generator`` uint8 ``[128, 32]``."""
    lead, trail = burst_ramps(sps)
    out = {
        "taps": tx_rrc_taps(sps),
        "lead_ramp": lead,
        "trail_ramp": trail,
        "ramp_bits_packed": _ramp_bits_packed(int(max_packets_glfsr)),
        "sync_syms": np.asarray(C.BPSK_CONSTELLATION)[np.asarray(C.SYNCWORD)],
        "qpsk": np.asarray(C.QPSK_CONSTELLATION),
        "ldpc_generator": load_generator(),
    }
    out.update({f"crc_{n}": v for n, v in crc32_tables(max_payload_len).items()})
    return out


def tables_from_numpy(d: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """numpy arrays and scalars -> CPU tensors with the same values. uint32
    (CRC words) becomes int64, since PyTorch's uint32 has few operators;
    Python floats become float64 scalars; every other dtype is kept."""
    out = {}
    for name, value in d.items():
        a = np.asarray(value)
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(a.copy())
    return out


def numpy_tables_of(source: object, attributes: dict[str, str] = JAX_ATTRIBUTES) -> dict[str, np.ndarray]:
    """Read the tables named in ``attributes`` (``JAX_ATTRIBUTES`` for a JAX
    ``Receiver``, ``TX_JAX_ATTRIBUTES`` for a ``Transmitter``) off a JAX
    object."""
    out = {}
    for name, path in attributes.items():
        obj = source
        for part in path.split("."):
            obj = getattr(obj, part)
        out[name] = obj
    return out
