"""Multi-GPU receiver bank: channels x time sharding with halo exchange
(port of ``gr4_packet_modem_tpu/parallel/bank.py`` to ``torch.distributed``).

The port is SPMD: one process per card, each holding one cell of a
``(ch, time)`` :class:`~torch.distributed.device_mesh.DeviceMesh`:

- ``ch``: independent RF channels, each rank a contiguous block of them;
- ``time``: each rank owns a contiguous time shard of its channels. The
  lookback and lookahead that the reference keeps in ring-buffer history
  (syncword_detection.hpp:236-238) become halos taken from the time
  neighbours: every rank all-gathers the two edge strips of each time shard
  along its ``time`` group and keeps its neighbours' (no send/receive
  ordering to get right; at four time shards or fewer it moves at most four
  times the bytes of a point-to-point exchange).

Each rank then runs the single-card receiver on its extended block, with
single-card detection semantics at the shard edges:

- candidate selection is restricted to the rank's own fresh window before
  the top-k (``acquire(fresh_lo=, fresh_hi=)``), so a strong peak in a halo
  cannot take a detection slot;
- the in-packet suppression scan chains across time shards: every shard's
  detection metadata (index, valid, extent) is all-gathered along ``time``
  and every shard runs the same scan over the concatenation, then keeps its
  own segment (syncword_detection_filter.hpp:4-18 on a mesh).

A packet crossing the shard edge is decoded by the shard its syncword
starts in, through the right halo (sized to the largest packet extent).
Every rank runs the same channel groups in the same order, so the
collectives match.
"""

from __future__ import annotations

from dataclasses import dataclass, fields

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.receiver import (
    PayloadResult,
    Receiver,
    RxConfig,
    flatten_detections,
    packet_extent_samples,
    suppress_overlapping,
)
from ..utils.trace import span

__all__ = [
    "BankConfig", "ReceiverBank", "make_mesh", "sharded_group_decode",
    "mesh_device", "mesh_shape", "gather_along",
]

_IDLE_BUSY = -(1 << 30)


def gather_along(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """``t`` of every rank of ``group``, concatenated along ``dim`` in
    group-rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def sharded_group_decode(
    rx: Receiver,
    g_ext: torch.Tensor,
    g_busy0: torch.Tensor,
    *,
    fresh_lo: int,
    fresh_len: int,
    shard_pos: int,
    time_group,
):
    """Decode one channel group's extended buffers on one time shard with
    single-card suppression semantics across shards.

    ``g_ext``: ``[G, L]`` complex64 (halo or history, own window,
    lookahead); ``g_busy0``: ``[G]`` int64 suppression seed in chain
    coordinates; ``[fresh_lo, fresh_lo + fresh_len)``: this shard's own
    fresh window in buffer coordinates; ``shard_pos``: buffer to chain
    coordinates (``chain = index + shard_pos``); ``time_group``: the
    process group of this rank's time shards, in shard order.

    Returns ``(detf, hdr, res, keep, busy_end)`` with rows flattened to
    ``[G*D]`` channel-major and ``busy_end`` ``[G]`` in chain coordinates
    (the scan's end state, the same on every time shard).
    """
    dd = rx.config.max_detections
    det = rx.acquirer.acquire(g_ext, fresh_lo=fresh_lo, fresh_hi=fresh_lo + fresh_len)
    detf, chan = flatten_detections(det, rx.channel_ids(*det.index.shape, det.index.device))
    hdr, _ = rx.decode_headers(g_ext, detf, chan)
    g = g_ext.shape[0]
    # its own scan, not Receiver.filter_detections: every time shard's
    # extents are exchanged between the header pass and the scan
    with span("rx.suppress", g_ext.device):  # the time shards' exchange included
        extent = packet_extent_samples(
            hdr.packet_length, hdr.header_ok, rx.config.samples_per_symbol
        ).view(g, dd)
        # shard k's rows land at [k*D, (k+1)*D): fresh windows are disjoint and
        # ascending and each shard's rows are index-sorted with the invalid ones
        # last (never claiming), so the concatenation is sorted where valid
        meta = torch.stack([det.index + shard_pos, det.valid.to(torch.int64), extent.to(torch.int64)])
        all_idx, all_valid, all_ext = gather_along(meta, time_group, dim=2)
        busy_end, keep_all = suppress_overlapping(all_idx, all_valid.bool(), all_ext, g_busy0)
        t = dist.get_rank(time_group)
        keep = keep_all[:, t * dd : (t + 1) * dd].reshape(-1)
    res = rx.decode_payloads(g_ext, detf, hdr, keep, chan)
    detf.overflow = det.overflow.any()
    # valid is fresh-window restricted already; keep makes it the row's
    # final verdict
    detf.valid = detf.valid & keep
    return detf, hdr, res, keep, busy_end


def make_mesh(
    n_devices: int | None = None,
    time_shards: int | None = None,
    device_type: str = "cuda",
) -> DeviceMesh:
    """A ``(ch, time)`` mesh over the first ``n_devices`` ranks (all of
    them by default) of the initialised process group, row-major (rank
    ``ch_idx * time_shards + t_idx``). The time split defaults to 2 when
    the count is even, else 1. Every rank calls it (subgroups are made
    collectively); a rank outside the mesh gets ``get_coordinate() is
    None``. ``device_type="cuda"`` needs CUDA; pass ``"cpu"`` for gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group (multihost.initialize)")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError('make_mesh(device_type="cuda"): CUDA is not available; pass device_type="cpu"')
    world = dist.get_world_size()
    n = n_devices or world
    if not 1 <= n <= world:
        raise ValueError(f"{n} devices asked of a world of {world}")
    if time_shards is None:
        time_shards = 2 if n % 2 == 0 else 1
    if time_shards < 1 or n % time_shards:
        raise ValueError(f"{n} devices do not split into {time_shards} time shards")
    ranks = torch.arange(n).reshape(n // time_shards, time_shards)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("ch", "time"))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its current CUDA device on a CUDA mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """``(ch_shards, time_shards)`` of a :func:`make_mesh` mesh that holds
    this rank."""
    if tuple(mesh.mesh_dim_names or ()) != ("ch", "time"):
        raise ValueError("mesh axes must be ('ch', 'time'): make_mesh")
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    c, t = mesh.mesh.shape
    return int(c), int(t)


@dataclass(frozen=True)
class BankConfig:
    """The receiver and its channel grouping; the bank's shape comes from
    the tensor each step is given."""

    rx: RxConfig = RxConfig()
    # channel groups run one after another within a rank's step, to bound
    # the [C_loc*D, region] working set (Receiver.bank_step's rule)
    channel_group: int = 16


class ReceiverBank:
    """Sharded receiver bank over a ``(ch, time)`` mesh: each rank holds one
    ordinary :class:`Receiver` (``bank.rx.load_tables`` carries tables
    over) and steps its own ``[C_loc, T_loc]`` cell."""

    def __init__(self, mesh: DeviceMesh, config: BankConfig = BankConfig(), device=None):
        self.c_shards, self.t_shards = mesh_shape(mesh)
        self.mesh = mesh
        self.config = config
        self.rx = Receiver(config.rx, device if device is not None else mesh_device(mesh))
        self.device = self.rx.arm_taps.device  # with its index ("cuda:0", not "cuda")
        # halos: lookback for the CFAR window and filter history, lookahead
        # for packets running past the shard's end
        self.left_halo = self.rx.front_pad
        self.right_halo = self.rx.pad_tail()
        self.ch_idx, self.t_idx = mesh.get_coordinate()
        self.time_group = mesh.get_group("time")

    def local_slice(self, x):
        """This rank's cell ``[C/ch_shards, T/time_shards]`` of a global
        bank ``x`` ``[C, T]`` (numpy or a tensor)."""
        c, t = x.shape
        if c % self.c_shards or t % self.t_shards:
            raise ValueError(f"bank {tuple(x.shape)} does not split over a {self.c_shards} x {self.t_shards} mesh")
        cl, tl = c // self.c_shards, t // self.t_shards
        return x[self.ch_idx * cl : (self.ch_idx + 1) * cl, self.t_idx * tl : (self.t_idx + 1) * tl]

    def _extended(self, x_loc: torch.Tensor) -> torch.Tensor:
        """``left halo | x_loc | right halo``: the last ``left_halo``
        samples of the left time neighbour and the first ``right_halo`` of
        the right one, zeros past the bank's ends."""
        lh, rh = self.left_halo, self.right_halo
        left, right = x_loc[:, -lh:], x_loc[:, :rh]
        nl = left.shape[1]
        strips = gather_along(torch.cat([left, right], dim=1)[None], self.time_group, dim=0)
        t, nt = self.t_idx, self.t_shards
        left = strips[t - 1, :, :nl] if t > 0 else torch.zeros_like(left)
        right = strips[t + 1, :, nl:] if t < nt - 1 else torch.zeros_like(right)
        return torch.cat([left, x_loc, right], dim=1)

    def step(self, x_loc: torch.Tensor) -> PayloadResult:
        """Decode this rank's cell ``x_loc`` ``[C_loc, T_loc]`` complex64
        on its device. Returns this rank's rows: a :class:`PayloadResult`
        with fields ``[C_loc, D, ...]``, the JAX bank's block ``[ch rows of
        this rank, t*D:(t+1)*D]``."""
        if x_loc.device != self.device or x_loc.dtype != torch.complex64 or x_loc.ndim != 2:
            raise ValueError(f"expected a [C_loc, T_loc] complex64 tensor on {self.device}, got "
                             f"{x_loc.dtype} {tuple(x_loc.shape)} on {x_loc.device}")
        t_loc = x_loc.shape[1]
        ext = self._extended(x_loc)
        # chain coordinates are global sample indices: buffer index i on
        # shard t is sample i - left_halo + t*T_loc
        shard_pos = self.t_idx * t_loc - self.left_halo
        c_loc = ext.shape[0]
        cg = self.config.channel_group
        g = cg if 0 < cg < c_loc and c_loc % cg == 0 else c_loc
        parts = []
        for grp in ext.split(g):
            seed = torch.full((grp.shape[0],), _IDLE_BUSY, dtype=torch.int64, device=self.device)
            parts.append(sharded_group_decode(
                self.rx, grp, seed, fresh_lo=self.left_halo, fresh_len=t_loc,
                shard_pos=shard_pos, time_group=self.time_group,
            )[2])
        dd = self.rx.config.max_detections
        return PayloadResult(*(
            torch.cat([getattr(p, f.name) for p in parts]).view(c_loc, dd, *getattr(parts[0], f.name).shape[1:])
            for f in fields(PayloadResult)
        ))

