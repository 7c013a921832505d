"""The receiver's constant tables, and carrying them across from the JAX
package.

The receive chain has no learned weights. Its parameters are constant
tables that the JAX ``Receiver`` holds as numpy arrays; the port builds the
same tables itself (:func:`receiver_tables`) and holds them as buffers of
its ``nn.Module``s. :func:`tables_from_numpy` turns a dict of such numpy
arrays into tensors, so ``Receiver.load_tables`` can compute from exactly
the JAX receiver's tables. ``JAX_ATTRIBUTES`` names where each table lives
on a JAX ``Receiver`` (:func:`numpy_tables_of` reads them without importing
JAX).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import constants as C
from ..utils.firdes import rx_pfb_taps

from ..ops.crc import crc32_tables
from ..ops.ldpc import decoder_tables

__all__ = [
    "JAX_ATTRIBUTES", "receiver_tables", "tables_from_numpy", "numpy_tables_of",
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


def numpy_tables_of(rx: object) -> dict[str, np.ndarray]:
    """Read the ``JAX_ATTRIBUTES`` tables off a JAX ``Receiver``."""
    out = {}
    for name, path in JAX_ATTRIBUTES.items():
        obj = rx
        for part in path.split("."):
            obj = getattr(obj, part)
        out[name] = obj
    return out
