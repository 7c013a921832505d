"""Sharded host-fed entry: ``StreamingShardedBank`` on ``make_mesh``'s
default ``(ch, time)`` mesh over ``world`` ranks, one card each, fed the
stream of ``entries/stream.py`` in the same closed loop.

This process is rank 0: it starts the other ranks (``spawn``), and every
rank makes the same cycle from the seed, joins the process group (NCCL on
the cards, gloo on the CPU) and builds its bank. Rank 0 alone measures and
prints: before each block it tells the others over a gloo group whether
to feed one more or to flush, so every rank feeds the same blocks (each
``process`` and the ``flush`` run the mesh's collectives). The window
ends with every rank flushing; the peak memory is the largest over the
ranks; rank 0 checks the packets (its ``process`` returns every cell's)
and the others exit, and rank 0 waits for them.
"""

from __future__ import annotations

import socket

import torch.distributed as dist
import torch.multiprocessing as mp

from h100_bench.entries import stream


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


STOP, FEED, FLUSH = 0, 1, 2


def _rank_state(rank: int, world: int, port: int, seed: int, config: dict, mix: dict, on_cuda: bool):
    import torch

    from gr4_packet_modem_tpu_torch.models.receiver import RxConfig
    from gr4_packet_modem_tpu_torch.parallel.bank import make_mesh, mesh_shape
    from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank

    if on_cuda:
        torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank) if on_cuda else torch.device("cpu")
    dist.init_process_group("nccl" if on_cuda else "gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    flags = dist.new_group(backend="gloo")
    block, c = int(config["block"]), int(mix["channels"])
    cycle, lay, pool = stream.make_cycle(seed, mix, block, c, dev)
    mesh = make_mesh(world, device_type=dev.type)
    bank = StreamingShardedBank(
        mesh, RxConfig(**config["rx"]), dev, channels=c, block=block,
        transfer_dtype=stream.WIRES[mix["transfer"]](torch), group=int(config.get("group", 0)),
        result_budget=stream.budget(config, block, pool.burst_len) * (c // mesh_shape(mesh)[0]),
    )
    st = {"cycle": cycle, "lay": lay, "pool": pool, "block": block, "span": cycle.shape[1],
          "flags": flags, "dev": dev}
    return bank, st


def _flag(st, go: int) -> int:
    import torch

    t = torch.tensor([go])
    dist.broadcast(t, 0, group=st["flags"])
    return int(t.item())


def _peak(st, value: int) -> int:
    import torch

    t = torch.tensor([value], dtype=torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=st["flags"])
    return int(t.item())


def _worker(rank: int, world: int, port: int, seed: int, config: dict, mix: dict, on_cuda: bool) -> None:
    import torch

    bank, st = _rank_state(rank, world, port, seed, config, mix, on_cuda)
    st.update(bank=bank, fed=0, packets=[], fed_at={}, out_at={})
    while _flag(st, STOP) == FEED:  # the warm-up
        stream.feed(st)
    if on_cuda:
        torch.cuda.reset_peak_memory_stats(st["dev"])
    while _flag(st, STOP) == FEED:  # the window, until rank 0 flushes
        stream.feed(st)
    bank.flush()
    _peak(st, torch.cuda.max_memory_allocated(st["dev"]) if on_cuda else 0)
    dist.destroy_process_group()


def setup(ctx):
    from h100_bench.entries import sharded  # the spawned ranks import the target by name

    world = int(ctx.mix["world"])
    on_cuda = ctx.device.type == "cuda"
    port = _free_port()
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=sharded._worker,
                           args=(r, world, port, ctx.seed, ctx.config, ctx.mix, on_cuda))
             for r in range(1, world)]
    for p in procs:
        p.start()
    bank, st = _rank_state(0, world, port, ctx.seed, ctx.config, ctx.mix, on_cuda)
    st["procs"] = procs
    ctx.mark("ranks")
    stream.instrument(ctx, bank, st)
    if "fault" in ctx.hooks:
        ctx.hooks["fault"](bank)
    st["before_feed"] = lambda: _flag(st, FEED)
    st["before_flush"] = lambda: _flag(st, FLUSH)
    stream.warm_up(ctx, st)
    _flag(st, STOP)  # the warm-up is over: the ranks reset their peaks
    return st


def window(ctx, st, seconds: float) -> None:
    stream.window(ctx, st, seconds)  # ends with every rank flushing
    rec = ctx.record
    peak = _peak(st, rec.get("window_peak_bytes", 0))
    if "window_peak_bytes" in rec:
        rec["window_peak_bytes"] = peak
        rec["memory_peak_bytes"] = max(rec["memory_peak_bytes"], peak)


def check(ctx, st) -> dict:
    bank = st["bank"]
    ovf = bank.overflow_blocks + bank.budget_overflow_blocks
    dist.destroy_process_group()
    for p in st["procs"]:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    bad = [p.exitcode for p in st["procs"] if p.exitcode != 0]
    del st["bank"], bank
    numbers = stream.compare(ctx, st, ovf)
    numbers["rank_failures"] = len(bad)
    return numbers
