"""K5: LDPC belief propagation on the card (``csrc/ldpc.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/ldpc_pallas.py::
ldpc_totals_pallas``. :func:`ldpc_totals` launches the CUDA kernel for CUDA
tensors and runs the plain version (``ops/ldpc.py::ldpc_totals_plain``) for
CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import kernel_route
from . import _build
from .ldpc import ldpc_totals_plain

__all__ = ["ldpc_totals", "ldpc_totals_plain"]


def ldpc_totals(
    llrs: torch.Tensor,
    chk_vars: torch.Tensor,
    var_edges: torch.Tensor,
    num_iterations: int = 25,
    normalization: float = 0.75,
) -> torch.Tensor:
    """Final per-variable totals ``[B, N]`` after BP on ``llrs`` float32
    ``[B, N]``, with the int32 tables of ``ops/ldpc.py::edge_tables``."""
    route = kernel_route(llrs, chk_vars, var_edges)
    if llrs.dtype != torch.float32 or llrs.ndim != 2:
        raise ValueError(f"llrs must be float32 [B, N], got {llrs.dtype} {tuple(llrs.shape)}")
    if chk_vars.dtype != torch.int32 or var_edges.dtype != torch.int32:
        raise ValueError("chk_vars and var_edges must be int32")
    if var_edges.shape[0] != llrs.shape[1]:
        raise ValueError(f"var_edges has {var_edges.shape[0]} rows for N={llrs.shape[1]}")
    if route == "plain":
        return ldpc_totals_plain(
            llrs, chk_vars, var_edges, num_iterations, normalization
        )
    for t in (llrs, chk_vars, var_edges):
        if not t.is_contiguous():
            raise ValueError("ldpc_totals needs contiguous tensors")
    b, n = llrs.shape
    m, dmax = chk_vars.shape
    totals = torch.empty_like(llrs)
    if b == 0:
        return totals
    _build.launch(
        "ldpc", "pm_ldpc_totals", llrs.device,
        llrs.data_ptr(), totals.data_ptr(), chk_vars.data_ptr(),
        var_edges.data_ptr(), b, m, dmax, n, var_edges.shape[1],
        int(num_iterations), float(np.float32(normalization)),
        _build.stream_of(llrs),
    )
    return totals
