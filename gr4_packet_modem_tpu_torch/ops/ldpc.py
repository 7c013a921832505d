"""Header LDPC (128,32) code: the encoder, and for decoding the tables,
repetition combining, the plain min-sum decoder and the hard decision.

Port of ``gr4_packet_modem_tpu/ops/ldpc.py``. The encoder works in exact
integer GF(2) arithmetic (AND, then the parity of a sum), where the JAX
package takes a float32 product. The
decoder is flooding normalised min-sum over a dense padded ``[96, 5]`` edge
table (the 96 checks have degree 3 to 5). :func:`ldpc_totals_plain` is the
counterpart of the JAX scan decoder (``HeaderLdpcDecoder.decode``) and the
plain version of the CUDA kernel in ``ops/ldpc_cuda.py``. Both sum each
variable's incoming messages in the order of :func:`edge_tables`, so they
agree bit for bit. :class:`HeaderLdpcDecoder` is the block-level decoder
(HeaderFecDecoder): BP through ``ops/ldpc_cuda.py::ldpc_totals`` (the
kernel K5 on CUDA tensors, the plain version on CPU tensors), then
:func:`finish`.
"""

from __future__ import annotations

from functools import lru_cache
from importlib import resources

import numpy as np
import torch
from torch import nn

from ..utils import constants as C

__all__ = [
    "load_generator", "encode_header", "load_parity_check", "decoder_tables", "edge_tables",
    "combine_repetition", "ldpc_totals_plain", "finish", "HeaderLdpcDecoder",
    "make_header_decoder",
]


@lru_cache(maxsize=1)
def load_generator() -> np.ndarray:
    """Codeword-from-info GF(2) matrix ``[128, 32]`` uint8 (read-only).

    Codeword = [info(32) | parity(96)]; parity r = parity(info & gen[r])
    with the u32 rows of this package's ``data/header_ldpc_generator.npy``
    applied MSB-first (header_fec_encoder.hpp:97-111)."""
    with (resources.files("gr4_packet_modem_tpu_torch.data") / "header_ldpc_generator.npy").open("rb") as f:
        gen = np.load(f)
    k = C.HEADER_LDPC_K
    g = np.zeros((C.HEADER_LDPC_N, k), dtype=np.uint8)
    g[:k] = np.eye(k, dtype=np.uint8)
    rows = gen[: C.HEADER_LDPC_N - k].astype(np.uint64)
    g[k:] = (rows[:, None] >> np.arange(k - 1, -1, -1, dtype=np.uint64)[None, :]) & 1
    g.flags.writeable = False
    return g


def encode_header(header_bits: torch.Tensor, generator: torch.Tensor | None = None) -> torch.Tensor:
    """Header info bits ``[B, 32]`` (MSB-first, 0/1) -> coded bits uint8
    ``[B, 256]``: the (128,32) codeword followed by its repetition
    (header_fec_encoder.hpp:93-115). ``generator`` is :func:`load_generator`
    as a tensor on the bits' device (built from it when None)."""
    if generator is None:
        generator = torch.from_numpy(load_generator().copy()).to(header_bits.device)
    prod = header_bits.to(torch.int64)[:, None, :] & generator.to(torch.int64)[None]
    cw = (prod.sum(dim=-1) & 1).to(torch.uint8)  # [B, 128]
    return torch.cat([cw, cw], dim=-1)


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


class HeaderLdpcDecoder(nn.Module):
    """Batched normalised min-sum BP decoder for the (128,32) header code
    on ``device``, its index tables (:func:`edge_tables`) and parity-check
    matrix held as buffers: those of :func:`decoder_tables`, or the ones
    given to :meth:`set_tables` (the receiver's carried tables)."""

    def __init__(
        self,
        num_iterations: int = 25,
        normalization: float = 0.75,
        device: str | torch.device = "cuda",
    ):
        super().__init__()
        self.num_iterations = int(num_iterations)
        self.normalization = float(normalization)
        dev = torch.device(device)
        t = {k: torch.from_numpy(v).to(dev) for k, v in decoder_tables().items()}
        self.set_tables(t["vidx"], t["vmask"], t["h"])

    def set_tables(self, vidx: torch.Tensor, vmask: torch.Tensor, h: torch.Tensor) -> None:
        """Decode with ``vidx``/``vmask``/``h`` (:func:`decoder_tables`'
        layout, on the decoder's device): ``h`` is held as it is, the index
        tables are built from the other two."""
        chk_vars, var_edges = edge_tables(vidx.cpu().numpy(), vmask.cpu().numpy(), h.shape[1])
        self.register_buffer("chk_vars", torch.from_numpy(chk_vars).to(h.device), persistent=False)
        self.register_buffer("var_edges", torch.from_numpy(var_edges).to(h.device), persistent=False)
        self.register_buffer("h", h, persistent=False)

    def decode(self, llrs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Decode a batch of codewords: ``llrs`` float32 ``[B, 128]`` on the
        decoder's device, positive = bit 0 more likely (the modem's LLR
        convention, constellation_llr_decoder.hpp:24-27). Returns
        ``(info_bits uint8 [B, 32], ok bool [B])``, ``ok`` the parity-check
        success flag."""
        from .ldpc_cuda import ldpc_totals  # ldpc_cuda imports this module

        total = ldpc_totals(
            llrs.to(torch.float32).contiguous(), self.chk_vars, self.var_edges,
            self.num_iterations, self.normalization,
        )
        return finish(total, self.h)


@lru_cache(maxsize=4)
def make_header_decoder(
    num_iterations: int = 25, device: str | torch.device = "cuda"
) -> HeaderLdpcDecoder:
    return HeaderLdpcDecoder(num_iterations=num_iterations, device=device)
