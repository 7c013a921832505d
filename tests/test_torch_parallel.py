"""The port's sharded receiver bank (``parallel/bank.py``) on a 2 ch x 2 time
gloo mesh of four spawned processes, against the JAX ``ReceiverBank`` at the
same two time shards and the port's single-device ``Receiver``.

The four cases of tests/test_parallel.py: all channels decode; a packet
across the shard edge decodes as on one device; a false syncword after the
edge, inside a straddling packet's claim, is suppressed; a strong peak in a
halo takes no detection slot. Every rank's rows ``[C_loc, D]`` must equal
the JAX bank's block ``[its channels, t*D:(t+1)*D]`` (accepted; lengths and
bytes on accepted rows: the others hold what an empty slot decodes to),
and each channel's decoded bytes over both shards the single-device
``Receiver.receive``'s, with the slots of both shards. The ranks import nothing of JAX;
the JAX side runs here, on the 8 virtual CPU devices of tests/conftest.py.
The bursts come from the port's transmitter and the noise from numpy.

The launcher and the rank set-up here serve tests/test_torch_serving.py
and tests/test_torch_multihost.py too.
"""

import json
import os
import sys
import time
from datetime import timedelta

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from gr4_packet_modem_tpu_torch.models.receiver import Receiver, RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.parallel.bank import BankConfig, ReceiverBank, make_mesh  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch  # noqa: E402

RXCFG = dict(max_payload_len=64, max_detections=4, freq_bins=1)
TOTAL = 8192  # two time shards of 4096


# --------------------------------------------------------------- launcher


def start_ranks(fn, world: int, tmp, *args):
    """Start ``fn(rank, world, store, *args)`` in ``world`` spawned
    processes with a ``file://`` store in ``tmp``."""
    store = os.path.join(str(tmp), "store")
    return mp.spawn(fn, args=(world, store, *args), nprocs=world, join=False)


def wait_ranks(ctx, timeout: float = 300.0) -> None:
    """Join the ranks of :func:`start_ranks`; raise if one failed or they
    outlive ``timeout`` seconds (then they are killed)."""
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{len(ctx.processes)} ranks still running after {timeout} s")


def init_rank(rank: int, world: int, store: str) -> None:
    """One thread, gloo over the ``file://`` store, 120 s collectives;
    nothing of JAX in the rank."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=timedelta(seconds=120))
    if "jax" in sys.modules:
        raise AssertionError("a rank imported jax")


def burst(payload: np.ndarray, max_len: int) -> np.ndarray:
    """One packet's burst samples from the port's transmitter (CPU)."""
    s, lens = Transmitter(TxConfig(max_payload_len=max_len), "cpu").modulate_bursts(
        PacketBatch.from_list([payload], max_len, "cpu"))
    return s[0, : int(lens[0])].numpy()


def packets_of(acc, lens, data) -> list[bytes]:
    return sorted(data[i, : lens[i]].tobytes() for i in np.nonzero(acc)[0])


# ------------------------------------------------------------- scenarios


def _scenarios() -> dict:
    """name -> (samples [C, 8192], RxConfig kwargs), after
    tests/test_parallel.py:35-194."""
    out = {}
    rng = np.random.default_rng(0)
    pays = [rng.integers(0, 256, n, dtype=np.uint8) for n in (50, 20)]
    stream = np.zeros(TOTAL, np.complex64)
    b = np.concatenate([burst(p, 64) for p in pays])
    stream[: b.size] = b
    out["all_channels"] = (np.tile(stream, (8, 1)), RXCFG)

    # the second packet starts 196 samples before the shard edge
    rng = np.random.default_rng(1)
    b0, b1 = (burst(rng.integers(0, 256, n, dtype=np.uint8), 64) for n in (30, 60))
    stream = np.zeros(TOTAL, np.complex64)
    stream[: b0.size] = b0
    stream[3900 : 3900 + b1.size] = b1
    noise = np.random.default_rng(2).standard_normal((2, TOTAL))
    stream = (stream + 0.05 * (noise[0] + 1j * noise[1])).astype(np.complex64)
    out["edge_packet"] = (np.tile(stream, (8, 1)), RXCFG)

    # a control packet, a packet straddling the edge at 4096 whose payload
    # is overwritten by a complete 8-byte packet at 4400 (after the outer
    # header, inside its claim): one device suppresses the inner one
    rng = np.random.default_rng(3)
    b_a, b_outer, b_inner = (burst(rng.integers(0, 256, n, dtype=np.uint8), 64) for n in (50, 60, 8))
    stream = np.zeros(TOTAL, np.complex64)
    stream[: b_a.size] = b_a
    stream[3600 : 3600 + b_outer.size] = b_outer
    stream[4400 : 4400 + b_inner.size] = b_inner
    out["false_syncword"] = (np.tile(stream, (4, 1)), RXCFG)

    # a 4x-power packet in shard 1's left halo against two slots
    rng = np.random.default_rng(4)
    b_h, b_1, b_2 = (burst(rng.integers(0, 256, 8, dtype=np.uint8), 64) for _ in range(3))
    stream = np.zeros(TOTAL, np.complex64)
    stream[4040 : 4040 + b_h.size] = 2.0 * b_h
    stream[5200 : 5200 + b_1.size] = b_1
    stream[6800 : 6800 + b_2.size] = b_2
    out["halo_peak"] = (np.tile(stream, (4, 1)), dict(RXCFG, max_detections=2))
    return out


SCENARIOS = ["all_channels", "edge_packet", "false_syncword", "halo_peak"]


def _mesh_cases() -> dict:
    """make_mesh's rule and errors, as a rank sees them."""
    out = {"cuda": torch.cuda.is_available()}
    for key, kw in (("world", {}), ("n2", {"n_devices": 2}), ("n3", {"n_devices": 3}),
                    ("t4", {"n_devices": 4, "time_shards": 4})):
        m = make_mesh(device_type="cpu", **kw)
        out[key] = [list(m.mesh.shape), m.get_coordinate()]
    for key, kw in (("t3", {"n_devices": 4, "time_shards": 3}), ("n5", {"n_devices": 5}), ("cuda_default", {})):
        if key != "cuda_default":
            kw = dict(kw, device_type="cpu")
        try:
            make_mesh(**kw)
            out[key] = None
        except (ValueError, RuntimeError) as e:
            out[key] = [type(e).__name__, str(e)]
    return out


def _rank_main(rank: int, world: int, store: str, inputs: str, out_dir: str) -> None:
    init_rank(rank, world, store)
    mesh = make_mesh(4, time_shards=2, device_type="cpu")
    data = np.load(inputs)
    for name in SCENARIOS:
        x, cfg = data[name], json.loads(str(data[name + "_cfg"]))
        bank = ReceiverBank(mesh, BankConfig(rx=RxConfig(**cfg)))
        res = bank.step(torch.from_numpy(np.ascontiguousarray(bank.local_slice(x))))
        np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), accepted=res.accepted.numpy(),
                 lengths=res.lengths.numpy(), data=res.data.numpy(), coord=np.array(bank.mesh.get_coordinate()))
    with open(os.path.join(out_dir, f"mesh_{rank}.json"), "w") as f:
        json.dump(_mesh_cases(), f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    scen = _scenarios()
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{k: v[0] for k, v in scen.items()},
             **{k + "_cfg": json.dumps(v[1]) for k, v in scen.items()})
    wait_ranks(start_ranks(_rank_main, 4, tmp, inputs, str(tmp)))
    return scen, tmp


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", SCENARIOS)
def test_bank_matches_jax_and_one_device(ranks, name):
    import jax.numpy as jnp

    from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig
    from gr4_packet_modem_tpu.parallel import bank as jbank

    scen, tmp = ranks
    x, cfg = scen[name]
    c, dd = x.shape[0], cfg["max_detections"]
    jb = jbank.ReceiverBank(jbank.make_mesh(8, time_shards=2), jbank.BankConfig(num_channels=c, rx=JConfig(**cfg)))
    jres = jb.step(jnp.asarray(x))
    jacc, jlens, jdata = (np.asarray(a) for a in (jres.accepted, jres.lengths, jres.data))
    assert jacc.shape == (c, 2 * dd)
    got = {ch: [] for ch in range(c)}
    c_loc = c // 2
    for rank in range(4):
        r = np.load(tmp / f"{name}_{rank}.npz")
        cs, ts = r["coord"]
        rows = slice(cs * c_loc, (cs + 1) * c_loc)
        cols = slice(ts * dd, (ts + 1) * dd)
        np.testing.assert_array_equal(r["accepted"], jacc[rows, cols], err_msg=f"rank {rank}")
        for i in range(c_loc):
            acc = r["accepted"][i]
            np.testing.assert_array_equal(r["lengths"][i][acc], jlens[rows, cols][i][acc], err_msg=f"rank {rank}")
            np.testing.assert_array_equal(r["data"][i][acc], jdata[rows, cols][i][acc], err_msg=f"rank {rank}")
            got[cs * c_loc + i] += packets_of(acc, r["lengths"][i], r["data"][i])

    # one device has the slots of both shards (halo_peak runs two a shard)
    one = Receiver(RxConfig(**dict(cfg, max_detections=2 * dd)), "cpu").receive(x[0])
    want = packets_of(one.accepted.numpy(), one.lengths.numpy(), one.data.numpy())
    expect_count = {"all_channels": 2, "edge_packet": 2, "false_syncword": 1, "halo_peak": 3}[name]
    assert len(want) == expect_count, f"one device decodes {len(want)} packets"
    for ch in range(c):
        assert sorted(got[ch]) == want, f"channel {ch}"


@pytest.mark.timeout(600)
def test_make_mesh_rule(ranks):
    """Row-major (ch, time) meshes: time split 2 for an even count, 1 for an
    odd one; ranks past ``n_devices`` are outside the mesh."""
    _, tmp = ranks
    for rank in range(4):
        with open(tmp / f"mesh_{rank}.json") as f:
            m = json.load(f)
        assert m["world"] == [[2, 2], [rank // 2, rank % 2]]
        assert m["n2"] == [[1, 2], [0, rank] if rank < 2 else None]
        assert m["n3"] == [[3, 1], [rank, 0] if rank < 3 else None]
        assert m["t4"] == [[1, 4], [0, rank]]


@pytest.mark.timeout(600)
def test_make_mesh_errors(ranks):
    """Counts that do not split, more devices than ranks, CUDA asked of a
    machine without it, and no process group at all."""
    _, tmp = ranks
    for rank in range(4):
        with open(tmp / f"mesh_{rank}.json") as f:
            m = json.load(f)
        assert m["t3"][0] == "ValueError" and "time shards" in m["t3"][1]
        assert m["n5"][0] == "ValueError" and "world of 4" in m["n5"][1]
        if not m["cuda"]:
            assert m["cuda_default"][0] == "RuntimeError" and "CUDA" in m["cuda_default"][1]
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(device_type="cpu")
