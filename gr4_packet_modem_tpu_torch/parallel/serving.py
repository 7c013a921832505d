"""Host-fed sharded serving driver: ``StreamingBank`` semantics on a
``(ch, time)`` device mesh (port of ``gr4_packet_modem_tpu/parallel/
serving.py`` to ``torch.distributed``).

Every rank runs one :class:`StreamingShardedBank` and is fed the same
``[C, n]`` samples; each keeps ``StreamingBank``'s guarantees (exactly-once
decode across block and time-shard boundaries, per-channel suppression
state carried across both, the int8 and int4 wires, the compacted result
wire, the parity and overflow gates):

1. the host stages only the rank's ``[2, C_loc, bs]`` slice of each block
   (``bs = block / time_shards``) in its pinned ring;
2. the slice goes to the rank's card and is all-gathered along the time
   group into ``[2, C_loc, block]``: the host link carries a 1/N share,
   the gather runs between cards;
3. the rank slides its channels' window (the last ``front_pad + pad_tail``
   samples persist on the card, as in ``StreamingBank``) and decodes its
   static sub-window ``window[:, t*bs : t*bs + front_pad + bs + pad_tail]``
   with :func:`~.bank.sharded_group_decode`: detections only in its own
   fresh ``bs`` samples, suppression chained across the time shards and
   seeded by the carried busy state;
4. it packs its own cell's result wire (channels local to the rank);
5. the packed wires of every cell are all-gathered over the world, so every
   rank's ``process`` returns every cell's packets, with the cell's first
   channel and the block's offset added on the host.

On a CUDA mesh a block costs no host synchronisation but the
materialisation of the block ``pipeline_depth`` behind (the collectives
queue on the device). The 1 x 1 mesh gives ``StreamingBank``'s packets in
the same order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..models.receiver import RxConfig
from ..runtime.streaming import StreamingBank
from .bank import mesh_shape, gather_along, mesh_device, sharded_group_decode

__all__ = ["StreamingShardedBank"]


class StreamingShardedBank(StreamingBank):
    """Host-fed multi-channel streaming receiver over a ``(ch, time)``
    mesh covering the world, one rank a cell.

    Same API and semantics as :class:`StreamingBank` (``process([C, n])``,
    ``flush()``, ``stats``, ``overflow_blocks``,
    ``budget_overflow_blocks``); ``result_budget`` counts slots per mesh
    cell, and ``group`` applies to the rank's own channels.
    """

    def __init__(
        self,
        mesh: DeviceMesh,
        config: RxConfig = RxConfig(),
        device=None,
        channels: int = 8,
        block: int = 1 << 18,
        transfer_dtype=None,
        pipeline_depth: int = 2,
        group: int = 16,
        result_budget: int | None = None,
        log: bool = False,
    ):
        c_shards, t_shards = mesh_shape(mesh)
        if mesh.mesh.numel() != dist.get_world_size():
            raise ValueError("StreamingShardedBank needs a mesh over the whole world")
        if channels % c_shards:
            raise ValueError(f"{channels} channels not divisible by {c_shards} ch shards")
        if block % t_shards:
            raise ValueError(f"block {block} not divisible by {t_shards} time shards")
        self.mesh = mesh
        self.c_shards, self.t_shards = c_shards, t_shards
        self.ch_idx, self.t_idx = mesh.get_coordinate()
        self.c_loc, self.bs = channels // c_shards, block // t_shards
        self.time_group = mesh.get_group("time")
        super().__init__(
            config,
            device if device is not None else mesh_device(mesh),
            channels=channels,
            block=block,
            transfer_dtype=transfer_dtype,
            pipeline_depth=pipeline_depth,
            group=group,
            result_budget=result_budget,
            log=log,
        )

    # ----------------------------------------------------------- the shard

    @property
    def local_channels(self) -> int:
        return self.c_loc

    @property
    def local_block(self) -> int:
        return self.bs

    def _cells(self) -> list[int]:
        return [cs * self.c_loc for cs in range(self.c_shards) for _ in range(self.t_shards)]

    def _stage_piece(self, i: int, f: int, piece: np.ndarray) -> None:
        """Stage the part of ``piece`` (block samples ``[f, f + w)``) that
        falls in this rank's channels and time slice."""
        lo, hi = self.t_idx * self.bs, (self.t_idx + 1) * self.bs
        a, b = max(f, lo), min(f + piece.shape[1], hi)
        if a < b:
            rows = slice(self.ch_idx * self.c_loc, (self.ch_idx + 1) * self.c_loc)
            super()._stage_piece(i, a - lo, piece[rows, a - f : b - f])

    def _block_planes(self, planes: torch.Tensor) -> torch.Tensor:
        return gather_along(planes, self.time_group, dim=2)

    def _gather_wire(self, packed: torch.Tensor) -> torch.Tensor:
        return gather_along(packed, None, dim=0)

    def _decode_group(self, buf: torch.Tensor, busy0: torch.Tensor):
        """Decode this rank's sub-window of one channel group's window
        ``buf`` ``[G, buf_len]``; indices come back in window
        coordinates."""
        fp, bs, pos = self.fp, self.bs, self.t_idx * self.bs
        sub = buf[:, pos : pos + fp + bs + self.pt].contiguous()
        detf, hdr, res, _, busy_end = sharded_group_decode(
            self.rx, sub, busy0, fresh_lo=fp, fresh_len=bs, shard_pos=pos,
            time_group=self.time_group,
        )
        return (
            detf.index + pos, res.lengths, hdr.packet_type, detf.esn0_db, detf.freq,
            hdr.arm, res.accepted, res.data, detf.overflow, busy_end,
        )
