"""Ragged packet batches (port of ``gr4_packet_modem_tpu/utils/ragged.py``).

A batch of packets is a dense padded tensor ``[B, max_len]`` plus a length
vector ``[B]`` (and the packet types), the counterpart of the reference's
``Pdu<T>`` items (pdu.hpp:14-19). Concatenating the rows' valid prefixes
into one stream is a parallel search-and-gather: each output position finds
its source row by a binary search over the rows' start offsets. A bank of
links concatenates link by link, each from its own offset, in one call.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["PacketBatch", "ragged_concat", "ragged_concat_lengths", "mask_from_lengths"]


@dataclass
class PacketBatch:
    """Dense ragged batch: ``data`` ``[B, max_len]`` (uint8 bytes, or
    complex64 symbols or samples), ``lengths`` int64 ``[B]`` valid items
    per row, ``types`` int64 ``[B]`` PacketType per row (None: all
    USER_DATA)."""

    data: torch.Tensor
    lengths: torch.Tensor
    types: torch.Tensor | None = None

    @property
    def batch(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    @classmethod
    def from_list(cls, packets, max_len: int | None, device, dtype=np.uint8, types=None):
        """Build on ``device`` from a list of 1-D arrays; ``max_len`` None
        takes the longest packet's length."""
        packets = [np.asarray(p) for p in packets]
        ml = max_len or max((p.size for p in packets), default=0)
        data = np.zeros((len(packets), ml), dtype=dtype)
        lens = np.zeros(len(packets), dtype=np.int64)
        for i, p in enumerate(packets):
            data[i, : p.size] = p
            lens[i] = p.size
        t = np.zeros(len(packets), np.int64) if types is None else np.asarray(types, np.int64)
        dev = torch.device(device)
        return cls(*(torch.from_numpy(a).to(dev) for a in (data, lens, t)))

    def to_list(self) -> list[np.ndarray]:
        data = self.data.cpu().numpy()
        lens = self.lengths.cpu().numpy()
        return [data[i, : lens[i]] for i in range(data.shape[0])]


def mask_from_lengths(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """Boolean validity mask ``[B, max_len]`` from a length vector."""
    return torch.arange(max_len, device=lengths.device)[None, :] < lengths[:, None]


def ragged_concat_lengths(lengths: torch.Tensor) -> torch.Tensor:
    """Start offset of each row in the concatenated stream."""
    return torch.cumsum(lengths.to(torch.int64), 0) - lengths.to(torch.int64)


def ragged_concat(
    data: torch.Tensor, lengths: torch.Tensor, out_len: int, fill=0, offset: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """Concatenate the valid prefixes of the rows of ``data`` ``[..., B, L]``
    into one stream ``[..., out_len]`` for each index of the leading axes
    (a bank's links: row ``k`` of link ``c`` is ``data[c, k]``, of
    ``lengths[c, k]`` items). Returns ``(out, total_len [...])``; entries
    past a stream's ``total_len`` are ``fill``. Rows of length 0 are
    skipped (the search takes the last row starting at or before a
    position). ``offset`` (int64 ``[...]``, None for 0) places each stream
    at that output position, ``fill`` before it."""
    lengths = lengths.to(torch.int64)
    lead, (b, width) = data.shape[:-2], data.shape[-2:]
    starts = torch.cat([lengths.new_zeros(*lead, 1), torch.cumsum(lengths, -1)], dim=-1)
    total = starts[..., -1]
    pos = torch.arange(out_len, device=data.device).expand(*lead, out_len)
    pos = pos.contiguous() if offset is None else pos - offset.to(torch.int64)[..., None]
    row = (torch.searchsorted(starts, pos, right=True) - 1).clamp(0, b - 1)
    off = (pos - starts.gather(-1, row)).clamp(0, width - 1)
    items = data.reshape(*lead, b * width).gather(-1, row * width + off)
    inside = (pos >= 0) & (pos < total[..., None])
    return torch.where(inside, items, data.new_full((), fill)), total
