"""Multi-process bring-up and scaling measurement (port of
``gr4_packet_modem_tpu/parallel/multihost.py`` to ``torch.distributed``).

- :func:`initialize` starts the process group from ``PM_COORDINATOR``,
  ``PM_NUM_PROCESSES`` and ``PM_PROCESS_ID``: NCCL on the cards, gloo when
  the caller asks for the CPU. One process runs per card.
- :func:`measure_scaling` times the sharded receiver bank over meshes of
  the first ``n`` ranks; scaling efficiency is rate per card at ``n`` over
  rate per card at the first count. The channel axis is independent and the
  time axis exchanges fixed-size halos, so efficiency should stay near 1
  while the block keeps the halo share small.
"""

from __future__ import annotations

import os
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "measure_scaling"]


def initialize(device_type: str = "cuda", timeout_s: float = 600.0) -> bool:
    """Start ``torch.distributed`` from the environment if it is set.

    ``PM_COORDINATOR`` is ``host:port`` (a ``tcp://`` rendezvous that
    process 0 serves) or an init URL such as ``file:///shared/path``;
    ``PM_NUM_PROCESSES`` and ``PM_PROCESS_ID`` give the world size and this
    process's rank. ``device_type="cuda"`` uses NCCL and selects the card
    ``rank % device_count``; ``"cpu"`` uses gloo. Returns False when
    ``PM_COORDINATOR`` is not set."""
    coord = os.environ.get("PM_COORDINATOR")
    if not coord:
        return False
    rank = int(os.environ["PM_PROCESS_ID"])
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('initialize(device_type="cuda"): CUDA is not available; pass device_type="cpu"')
        torch.cuda.set_device(rank % torch.cuda.device_count())
        backend = "nccl"
    elif device_type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"device_type {device_type!r} not in ('cuda', 'cpu')")
    dist.init_process_group(
        backend,
        init_method=coord if "://" in coord else f"tcp://{coord}",
        world_size=int(os.environ["PM_NUM_PROCESSES"]),
        rank=rank,
        timeout=timedelta(seconds=timeout_s),
    )
    return True


def measure_scaling(
    signal_per_channel: np.ndarray,
    device_counts=(1, None),
    channels_per_device: int = 8,
    iters: int = 10,
    rx_config=None,
    device_type: str = "cuda",
):
    """Receiver-bank samples/s per card at several device counts (``None``
    is the whole world; a count above the world or repeated is skipped).
    Every rank calls it; ranks outside a point's mesh wait for it. Rank 0
    returns a list of dicts ``{devices, samples_per_sec, per_chip,
    efficiency}``, the other ranks None."""
    from ..models.receiver import RxConfig
    from .bank import BankConfig, ReceiverBank, make_mesh

    rx_config = rx_config or RxConfig(max_payload_len=256, max_detections=16)
    world = dist.get_world_size()
    results, seen, base = [], set(), None
    block = signal_per_channel.size
    for n in device_counts:
        n = n or world
        if n > world or n in seen:
            # a repeated count measures nothing: a point that reports its
            # own efficiency is not scaling evidence
            continue
        seen.add(n)
        mesh = make_mesh(n, device_type=device_type)
        if mesh.get_coordinate() is not None:
            ch = channels_per_device * mesh.mesh.shape[0]
            bank = ReceiverBank(mesh, BankConfig(rx=rx_config))
            x = np.tile(np.asarray(signal_per_channel, np.complex64)[None], (ch, 1))
            x_loc = torch.from_numpy(np.ascontiguousarray(bank.local_slice(x))).to(bank.device)
            bank.step(x_loc).accepted.sum().item()  # warm-up
            _sync(device_type)
            t0 = time.perf_counter()
            for _ in range(iters):
                out = bank.step(x_loc)
            out.accepted.sum().item()
            _sync(device_type)
            dt = (time.perf_counter() - t0) / iters
            sps = ch * block / dt
            base = base or sps / n
            results.append({"devices": n, "samples_per_sec": sps, "per_chip": sps / n,
                            "efficiency": sps / n / base})
        dist.barrier()
    return results if dist.get_rank() == 0 else None


def _sync(device_type: str) -> None:
    if device_type == "cuda":
        torch.cuda.synchronize()
