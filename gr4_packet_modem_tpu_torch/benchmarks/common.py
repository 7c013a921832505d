"""Shared harness of the measurement programs (port of
``benchmarks/common.py``): the timer, the JSON record, the tiled burst
stimulus, and the command line and process group the programs share."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..apps import split_device_arg
from ..models.transmitter import Transmitter, TxConfig
from ..parallel import multihost
from ..utils.device import require_device
from ..utils.ragged import PacketBatch, ragged_concat

__all__ = [
    "sync", "time_fn", "report", "tiled_burst_signal", "parse", "arg", "card_line", "card_fields",
    "process_group",
]


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn, *args, iters: int = 10, warmup: int = 1, device="cuda"):
    """Time ``fn(*args)``; returns ``(seconds_per_call, first_call_seconds)``.
    The card is synchronised after the first call, after the warm-up calls
    and after the timed loop (where the JAX harness blocks on the result)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    fn(*args)
    sync(dev)
    first_s = time.perf_counter() - t0
    for _ in range(warmup):
        fn(*args)
        sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) / iters, first_s


def report(metric: str, value: float, unit: str, baseline: float | None = None,
           echo: bool = True, **extra) -> dict:
    """The JAX harness's record: ``metric``, ``value`` (4 significant
    digits), ``unit``, ``vs_baseline`` where a baseline is given, then
    ``extra``. Printed as one JSON line when ``echo``; returned."""
    rec = {"metric": metric, "value": float(f"{value:.4g}"), "unit": unit}
    if baseline:
        rec["vs_baseline"] = float(f"{value / baseline:.4g}")
    rec.update(extra)
    if echo:
        print(json.dumps(rec), flush=True)
    return rec


def tiled_burst_signal(payload_len=1500, num_packets=12, total=1 << 18,
                       max_payload_len=1536, seed=0, device="cuda"):
    """Continuous back-to-back burst stream tiled to ``total`` samples:
    ``num_packets`` random payloads (``np.random.default_rng(seed)``) as
    bursts of the port's transmitter on ``device``, concatenated and tiled
    on the host. Returns ``(samples complex64 [total], complete bursts
    inside the block)``."""
    dev = torch.device(device)
    tx = Transmitter(TxConfig(max_payload_len=max_payload_len), dev)
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, payload_len, dtype=np.uint8) for _ in range(num_packets)]
    s, lens = tx.modulate_bursts(PacketBatch.from_list(payloads, max_payload_len, dev))
    stream = ragged_concat(s, lens, int(lens.sum()))[0].cpu().numpy()
    lens = lens.cpu().numpy()
    reps = total // stream.size + 1
    sig = np.tile(stream, reps)[:total]
    bounds = np.cumsum(np.tile(lens, reps))
    return sig, int(np.sum(bounds <= total))


def parse(argv: list[str] | None, device) -> tuple[list[str], torch.device]:
    """Take ``--device`` out of ``argv`` (default ``device``); returns the
    positional arguments and the device (a CUDA device without a card
    raises)."""
    rest, name = split_device_arg(list(argv or []), default=str(device))
    return rest, require_device(name)


def arg(rest: list[str], i: int, default):
    """Positional argument ``i`` converted as ``default`` is, or ``default``."""
    return type(default)(rest[i]) if len(rest) > i else default


def card_line() -> str | None:
    """``nvidia-smi``'s name and power limit of the first card (None where
    ``nvidia-smi`` is missing)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    return out.strip().splitlines()[0]


def card_fields(device: torch.device) -> dict:
    """``{"card": card_line()}`` on a CUDA device (a record's rates stand
    beside the card's name and power limit), else nothing."""
    return {"card": card_line()} if device.type == "cuda" else {}


@contextlib.contextmanager
def process_group(device: torch.device):
    """Run the body as a rank of a process group: the one initialised
    already, else one started from ``PM_COORDINATOR`` /
    ``PM_NUM_PROCESSES`` / ``PM_PROCESS_ID`` (``multihost.initialize``),
    else a world of one over a ``file://`` store in a temporary directory
    (NCCL on the card, gloo on the CPU). A group started here is destroyed
    on the way out."""
    if dist.is_initialized():
        yield
        return
    with contextlib.ExitStack() as stack:
        if not multihost.initialize(device.type):
            tmp = stack.enter_context(tempfile.TemporaryDirectory(prefix="pm_bench_"))
            if device.type == "cuda" and device.index is not None:
                torch.cuda.set_device(device)
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method=f"file://{os.path.join(tmp, 'store')}", world_size=1, rank=0,
            )
        try:
            yield
        finally:
            dist.destroy_process_group()
