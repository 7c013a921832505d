"""Process groups for the mesh examples.

An example's ``run()`` calls :func:`in_group`: a process that is already a
rank of a process group, or that can start one from ``PM_COORDINATOR`` /
``PM_NUM_PROCESSES`` / ``PM_PROCESS_ID``, runs the example as that rank.
Otherwise :func:`spawn` starts ``world`` local ranks with
``torch.multiprocessing.spawn`` over a ``file://`` store in a temporary
directory (NCCL and one card a rank on CUDA, gloo and one thread a rank on
the CPU), runs the examples in them one after another, and hands back rank
0's printed lines and result, with every rank's kernel launch counts.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..ops import _build
from ..parallel import multihost

__all__ = ["in_group", "spawn", "parser"]


def parser(module: str) -> argparse.ArgumentParser:
    """A mesh example's command line (``--device`` is taken out before
    it): ``--world``."""
    p = argparse.ArgumentParser(prog=f"python -m {module}")
    p.add_argument("--world", type=int, default=1,
                   help="local ranks to spawn when no process group is set up (default 1)")
    return p


def in_group(device: torch.device) -> bool:
    """Whether this process is a rank of an initialised process group,
    starting one from the environment if it is set."""
    return dist.is_initialized() or multihost.initialize(device.type)


def spawn(jobs: list[tuple[str, list[str]]], world: int, device_type: str, echo=print) -> list[dict]:
    """Run each ``(module, argv)`` of ``jobs`` in order on ``world`` new
    local ranks of one process group. Echoes rank 0's lines of each job
    and returns rank 0's results, each with ``rank_launches`` (every
    rank's kernel launch counts over that job alone) and ``run_seconds``
    (rank 0's wall time of the job)."""
    if world < 1:
        raise ValueError(f"--world {world}: needs at least one rank")
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"--world {world} needs {world} cards, {torch.cuda.device_count()} found")
    with tempfile.TemporaryDirectory(prefix="pm_mesh_") as tmp:
        mp.spawn(_rank, args=(world, tmp, device_type, jobs), nprocs=world)
        out = []
        for j in range(len(jobs)):
            ranks = []
            for r in range(world):
                with open(os.path.join(tmp, f"{j}.{r}.pkl"), "rb") as f:
                    ranks.append(pickle.load(f))
            for line in ranks[0]["lines"]:
                echo(line)
            out.append(dict(ranks[0]["result"], rank_launches=[r["launches"] for r in ranks],
                            run_seconds=ranks[0]["seconds"]))
    return out


def _rank(rank: int, world: int, tmp: str, device_type: str, jobs) -> None:
    """One spawned rank: join the group, run every job, write its lines,
    result (rank 0) and launch counts to ``tmp``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{os.path.join(tmp, 'store')}",
                            rank=rank, world_size=world, timeout=timedelta(seconds=300))
    try:
        for j, (module, argv) in enumerate(jobs):
            lines = []
            run = importlib.import_module(module).run
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            res = run(argv, echo=lines.append)
            if device_type == "cuda":
                torch.cuda.synchronize()
            with open(os.path.join(tmp, f"{j}.{rank}.pkl"), "wb") as f:
                pickle.dump({"lines": lines, "launches": _build.launch_counts(),
                             "seconds": time.perf_counter() - t0,
                             "result": res if rank == 0 else None}, f)
    finally:
        dist.destroy_process_group()
