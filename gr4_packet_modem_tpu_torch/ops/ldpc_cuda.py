"""K5: LDPC belief propagation on the card (``csrc/ldpc.cu``).

Counterpart of ``gr4_packet_modem_tpu/ops/ldpc_pallas.py::
ldpc_totals_pallas``. :func:`ldpc_totals` launches the CUDA kernel for CUDA
tensors and runs the plain version (``ops/ldpc.py::ldpc_totals_plain``) for
CPU tensors.

The kernel decodes one codeword per warp. :func:`warp_plan` is its plan in
numpy (which lane owns which variables and checks, and which slots of the
warp's two shared arrays each phase reads and publishes); the CPU tests run
BP along it. The limits and slots below are the kernel's compile-time
constants (``csrc/ldpc_warp.cuh``); :func:`ldpc_totals` refuses tables
beyond them on either route.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import kernel_route
from . import _build
from .ldpc import ldpc_totals_plain

__all__ = ["ldpc_totals", "ldpc_totals_plain", "check_limits", "warp_plan"]

WARP = 32
VARS_PER_LANE = 4
CHECKS_PER_LANE = 3
VAR_DEG = 3
MAX_CHECK_DEG = 5
# slots past the code's in the warp's message array (c2v) and totals array
ZERO_MSG = WARP * CHECKS_PER_LANE * MAX_CHECK_DEG  # always 0.0
TRASH_MSG = ZERO_MSG + 1
C2V_FLOATS = TRASH_MSG + 1
INF_TOTAL = WARP * VARS_PER_LANE  # always +inf
TRASH_TOTAL = INF_TOTAL + 1
TOT_FLOATS = TRASH_TOTAL + 1


def check_limits(m: int, dmax: int, n: int, vdeg: int) -> None:
    """Raise ``ValueError`` for a code the kernel's warp plan cannot hold:
    ``m`` checks of up to ``dmax`` slots, ``n`` variables of up to ``vdeg``
    edges."""
    limits = (
        ("variables", n, WARP * VARS_PER_LANE),
        ("checks", m, WARP * CHECKS_PER_LANE),
        ("variable degree", vdeg, VAR_DEG),
        ("check degree", dmax, MAX_CHECK_DEG),
    )
    for what, got, most in limits:
        if got > most:
            raise ValueError(f"ldpc kernel: {what} {got} > {most} (csrc/ldpc_warp.cuh)")


def warp_plan(chk_vars: np.ndarray, var_edges: np.ndarray) -> dict[str, np.ndarray]:
    """The kernel's plan for the tables of ``ops/ldpc.py::edge_tables``.

    Lane ``l`` owns variables ``l + 32k`` and checks ``l + 32k``. Slots
    index the warp's message array (``C2V_FLOATS``: message of edge
    ``c * dmax + j`` at that id, then ``ZERO_MSG`` and ``TRASH_MSG``) and
    totals array (``TOT_FLOATS``: variable ``v`` at ``v``, then
    ``INF_TOTAL`` and ``TRASH_TOTAL``):

    - ``vars`` ``[32, VARS_PER_LANE]``: variable id, -1 where none;
    - ``var_in`` ``[32, VARS_PER_LANE, VAR_DEG]``: the message slot each
      edge of an owned variable reads, in the table's order (``ZERO_MSG``
      for padding: it adds 0.0);
    - ``var_out`` ``[32, VARS_PER_LANE]``: where each total is published
      (``TRASH_TOTAL`` where none);
    - ``checks`` ``[32, CHECKS_PER_LANE]``: check id, -1 where none;
    - ``chk_in`` ``[32, CHECKS_PER_LANE, MAX_CHECK_DEG]``: the total slot
      each check slot reads (``INF_TOTAL`` for padding: its extrinsic value
      is +inf, sign +1 and magnitude inf, the plain version's mask);
    - ``chk_out`` ``[32, CHECKS_PER_LANE, MAX_CHECK_DEG]``: where each new
      message is published (``TRASH_MSG`` for padding).
    """
    chk_vars = np.asarray(chk_vars)
    var_edges = np.asarray(var_edges)
    (m, dmax), (n, vdeg) = chk_vars.shape, var_edges.shape
    check_limits(m, dmax, n, vdeg)
    lanes = np.arange(WARP)[:, None]
    vars_ = lanes + WARP * np.arange(VARS_PER_LANE)[None, :]
    vars_ = np.where(vars_ < n, vars_, -1)
    ve = np.full((WARP, VARS_PER_LANE, VAR_DEG), -1, np.int64)
    ve[..., :vdeg] = np.where(vars_[..., None] >= 0, var_edges[vars_.clip(0)], -1)
    checks = lanes + WARP * np.arange(CHECKS_PER_LANE)[None, :]
    checks = np.where(checks < m, checks, -1)
    cv = np.full((WARP, CHECKS_PER_LANE, MAX_CHECK_DEG), -1, np.int64)
    cv[..., :dmax] = np.where(checks[..., None] >= 0, chk_vars[checks.clip(0)], -1)
    out = checks[..., None] * dmax + np.arange(MAX_CHECK_DEG)
    return {
        "vars": vars_,
        "var_in": np.where(ve >= 0, ve, ZERO_MSG),
        "var_out": np.where(vars_ >= 0, vars_, TRASH_TOTAL),
        "checks": checks,
        "chk_in": np.where(cv >= 0, cv, INF_TOTAL),
        "chk_out": np.where(cv >= 0, out, TRASH_MSG),
    }


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
    b, n = llrs.shape
    m, dmax = chk_vars.shape
    check_limits(m, dmax, n, var_edges.shape[1])
    if route == "plain":
        return ldpc_totals_plain(
            llrs, chk_vars, var_edges, num_iterations, normalization
        )
    for t in (llrs, chk_vars, var_edges):
        if not t.is_contiguous():
            raise ValueError("ldpc_totals needs contiguous tensors")
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
