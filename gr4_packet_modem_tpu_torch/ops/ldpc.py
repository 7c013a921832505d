"""Header LDPC (128,32) decoding: tables, repetition combining, the plain
min-sum decoder and the hard decision.

Port of the decoding half of ``gr4_packet_modem_tpu/ops/ldpc.py``. The
decoder is flooding normalised min-sum over a dense padded ``[96, 5]`` edge
table (the 96 checks have degree 3 to 5). :func:`ldpc_totals_plain` is the
counterpart of the JAX scan decoder (``HeaderLdpcDecoder.decode``) and the
plain version of the CUDA kernel in ``ops/ldpc_cuda.py``. Both sum each
variable's incoming messages in the order of :func:`edge_tables`, so they
agree bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from importlib import resources

import numpy as np
import torch

from ..utils import constants as C

__all__ = [
    "load_parity_check", "decoder_tables", "edge_tables",
    "combine_repetition", "ldpc_totals_plain", "finish",
]


@lru_cache(maxsize=1)
def load_parity_check() -> np.ndarray:
    """Parity-check matrix H ``[96, 128]`` parsed from the alist data file
    in this package's ``data/``."""
    alist = resources.files("gr4_packet_modem_tpu_torch.data") / "header_ldpc.alist"
    lines = [ln for ln in alist.read_text().split("\n") if ln.strip()]
    n, m = map(int, lines[0].split())
    h = np.zeros((m, n), dtype=np.uint8)
    for v in range(n):
        for c in map(int, lines[4 + v].split()):
            h[c - 1, v] = 1
    return h


def decoder_tables() -> dict[str, np.ndarray]:
    """The decoder's constant tables, built as the JAX decoder builds them:
    ``vidx`` int32 ``[M, Dmax]`` (variable per check slot, 0-padded),
    ``vmask`` bool ``[M, Dmax]`` and ``h`` float32 ``[M, N]``."""
    h = load_parity_check()
    m = h.shape[0]
    max_deg = int(h.sum(axis=1).max())
    vidx = np.zeros((m, max_deg), dtype=np.int32)
    vmask = np.zeros((m, max_deg), dtype=bool)
    for c in range(m):
        vs = np.nonzero(h[c])[0]
        vidx[c, : vs.size] = vs
        vmask[c, : vs.size] = True
    return {"vidx": vidx, "vmask": vmask, "h": h.astype(np.float32)}


def edge_tables(
    vidx: np.ndarray, vmask: np.ndarray, n: int
) -> tuple[np.ndarray, np.ndarray]:
    """Index tables of the decoder, from ``vidx``/``vmask``:

    - ``chk_vars`` int32 ``[M, Dmax]``: the variable of each check slot, -1
      on padding;
    - ``var_edges`` int32 ``[N, Vmax]``: the flat edge ids (``c * Dmax + j``)
      that reach each variable, ascending, -1 on padding.
    """
    vidx = np.asarray(vidx)
    vmask = np.asarray(vmask, dtype=bool)
    chk_vars = np.where(vmask, vidx, -1).astype(np.int32)
    flat = chk_vars.reshape(-1)
    edges = [np.nonzero(flat == v)[0] for v in range(n)]
    vmax = max(e.size for e in edges)
    var_edges = np.full((n, vmax), -1, dtype=np.int32)
    for v, e in enumerate(edges):
        var_edges[v, : e.size] = e
    return chk_vars, var_edges


def combine_repetition(llrs256: torch.Tensor) -> torch.Tensor:
    """Sum the two repetition halves (header_fec_decoder.hpp:316-319)."""
    return llrs256[..., : C.HEADER_LDPC_N] + llrs256[..., C.HEADER_LDPC_N :]


def ldpc_totals_plain(
    llrs: torch.Tensor,
    chk_vars: torch.Tensor,
    var_edges: torch.Tensor,
    num_iterations: int = 25,
    normalization: float = 0.75,
) -> torch.Tensor:
    """Final per-variable LLR totals after ``num_iterations`` flooding
    iterations of normalised min-sum. ``llrs``: float32 ``[B, N]``, positive
    = bit 0 more likely; tables from :func:`edge_tables`."""
    b, n = llrs.shape
    m, dmax = chk_vars.shape
    mask = chk_vars >= 0
    cvars = chk_vars.clamp(min=0).long()
    # padding edges of var_edges point at one extra, always-zero message
    vedges = torch.where(var_edges >= 0, var_edges, m * dmax).long()
    alpha = float(np.float32(normalization))
    zero = llrs.new_zeros(b, 1)

    def var_totals(c2v):
        flat = torch.cat([c2v.reshape(b, m * dmax), zero], dim=1)
        g = flat[:, vedges]  # [B, N, Vmax]
        acc = torch.zeros_like(llrs)
        for j in range(vedges.shape[1]):
            acc = acc + g[:, :, j]
        return llrs + acc

    c2v = llrs.new_zeros(b, m, dmax)
    for _ in range(num_iterations):
        total = var_totals(c2v)
        v2c = total[:, cvars] - c2v  # extrinsic, [B, M, Dmax]
        sgn = torch.where(v2c >= 0, 1.0, -1.0)
        sgn = torch.where(mask, sgn, 1.0)
        mag = torch.where(mask, v2c.abs(), torch.inf)
        tot_sgn = torch.prod(sgn, dim=-1, keepdim=True)
        m1 = mag.min(dim=-1, keepdim=True).values
        arg1 = mag.argmin(dim=-1, keepdim=True)  # first minimum
        m2 = mag.scatter(-1, arg1, torch.inf).min(dim=-1, keepdim=True).values
        out_mag = torch.where(mag == m1, m2, m1)
        c2v = alpha * (tot_sgn * sgn) * torch.clamp(out_mag, max=1e30)
    return var_totals(c2v)


def finish(total: torch.Tensor, h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Hard decision + parity syndrome check on the final totals. Returns
    ``(info_bits uint8 [B, 32], ok bool [B])``. The syndrome sums at most
    five 0/1 terms per check, exact in any float precision."""
    hard = (total < 0).to(torch.uint8)  # positive LLR -> bit 0
    syndrome = torch.matmul(hard.to(h.dtype), h.T)
    ok = ((syndrome.round().to(torch.int64) & 1) == 0).all(dim=-1)
    return hard[:, : C.HEADER_LDPC_K], ok
