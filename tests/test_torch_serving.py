"""The port's sharded serving driver (``parallel/serving.py``) on gloo
meshes of spawned processes: 1 x 1, and 2 ch x 2 time.

The six cases of tests/test_serving.py:62-165 on the stimulus of that file
(four packets a channel of 20..127 bytes, offsets staggered so packets
straddle block and time-shard boundaries, blocks of 4096): the packet keys
``(channel, index, bytes, arm)`` of a 2 x 2 mesh equal the port's
``StreamingBank`` and the JAX ``StreamingShardedBank`` on ``make_mesh(8,
time_shards=2)``; the 1 x 1 mesh gives ``StreamingBank``'s list in order;
budget None equals budget 3 a cell; channel groups of 2 equal one group on
8 channels; the int8 and int4 wires decode every packet. Every rank returns
every cell's packets, and all ranks return the same list. The bursts come
from the port's transmitter (CPU).
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from gr4_packet_modem_tpu_torch.models.receiver import RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.models.transmitter import Transmitter, TxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.parallel.bank import make_mesh  # noqa: E402
from gr4_packet_modem_tpu_torch.parallel.serving import StreamingShardedBank  # noqa: E402
from gr4_packet_modem_tpu_torch.runtime.streaming import StreamingBank  # noqa: E402
from gr4_packet_modem_tpu_torch.utils.ragged import PacketBatch, ragged_concat  # noqa: E402
from test_torch_parallel import init_rank, start_ranks, wait_ranks  # noqa: E402

BLOCK = 4096
CFG = dict(max_payload_len=128, max_detections=4, freq_bins=1)

# (stimulus, transfer_dtype, result_budget, group) of each run on the 2 x 2 mesh
RUNS_2X2 = {
    "f32": ("four", None, None, 0),
    "budget3": ("four", None, 3, 0),
    "int8": ("four", "int8", 4, 0),
    "int4": ("four", "int4", 4, 0),
    "group0": ("eight", None, None, 0),
    "group2": ("eight", None, None, 2),
}


def _stimulus(channels, seed):
    """tests/test_serving.py:40-56 with the port's transmitter."""
    rng = np.random.default_rng(seed)
    ch_payloads = [[rng.integers(0, 256, n, dtype=np.uint8) for n in rng.integers(20, 128, 4)]
                   for _ in range(channels)]
    tx = Transmitter(TxConfig(max_payload_len=128), "cpu")
    streams = []
    for c, pays in enumerate(ch_payloads):
        s, lens = tx.modulate_bursts(PacketBatch.from_list(pays, 128, "cpu"))
        stream = ragged_concat(s, lens, int(lens.sum()))[0].numpy()
        streams.append((stream * np.exp(1j * 0.3 * c)).astype(np.complex64))
    x = np.zeros((channels, max(s.size for s in streams) + 2 * BLOCK), np.complex64)
    for c, s in enumerate(streams):
        off = 150 + 731 * c
        x[c, off : off + s.size] = s
    return x, ch_payloads


def _record(p):
    return [p.channel, p.index, p.data.tobytes().hex(), p.arm, p.packet_type, p.esn0_db, p.freq]


def _key(rec):
    return (rec[0], rec[1], rec[2], rec[3])


def _run(bank, x):
    pkts = bank.process(x) + bank.flush()
    return {"packets": [_record(p) for p in pkts], "overflow": bank.overflow_blocks,
            "budget_overflow": bank.budget_overflow_blocks}


def _rank_main(rank: int, world: int, store: str, inputs: str, out_dir: str) -> None:
    init_rank(rank, world, store)
    data = np.load(inputs)
    mesh = make_mesh(device_type="cpu")
    runs = RUNS_2X2 if world == 4 else {"one": ("two", None, None, 0)}
    out = {}
    for name, (stim, wire, budget, group) in runs.items():
        x = data[stim]
        bank = StreamingShardedBank(
            mesh, RxConfig(**CFG), channels=x.shape[0], block=BLOCK, group=group,
            transfer_dtype=torch.int8 if wire == "int8" else wire, result_budget=budget,
        )
        out[name] = _run(bank, x)
    if world == 4:
        try:  # 2 time shards of 2049 samples: odd
            StreamingShardedBank(mesh, RxConfig(**CFG), channels=4, block=2 * 2049, transfer_dtype="int4")
            out["odd_int4"] = None
        except ValueError as e:
            out["odd_int4"] = str(e)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both meshes' runs (the spawned ranks work while the references run
    here) and the references: the port's ``StreamingBank`` on the 4- and
    2-channel stimuli."""
    tmp = tmp_path_factory.mktemp("serving")
    stim = {"four": _stimulus(4, 11), "eight": _stimulus(8, 15), "two": _stimulus(2, 12)}
    inputs = str(tmp / "inputs.npz")
    np.savez(inputs, **{k: v[0] for k, v in stim.items()})
    dirs = {w: tmp / f"world{w}" for w in (4, 1)}
    ctxs = []
    for w, d in dirs.items():
        d.mkdir()
        ctxs.append(start_ranks(_rank_main, w, d, inputs, str(d)))
    refs = {}
    for name in ("four", "two"):
        x = stim[name][0]
        ref = StreamingBank(RxConfig(**CFG), "cpu", channels=x.shape[0], block=BLOCK, group=0)
        refs[name] = _run(ref, x)
    for ctx in ctxs:
        wait_ranks(ctx)
    runs = {}
    for w, d in dirs.items():
        per_rank = []
        for r in range(w):
            with open(d / f"rank{r}.json") as f:
                per_rank.append(json.load(f))
        assert all(p == per_rank[0] for p in per_rank), "ranks returned different packets"
        runs.update(per_rank[0])
    return stim, refs, runs


def _clean(run):
    assert run["overflow"] == 0 and run["budget_overflow"] == 0, run


@pytest.mark.timeout(600)
def test_sharded_bank_matches_streaming_bank_and_jax(served):
    """2 ch x 2 time == StreamingBank == the JAX StreamingShardedBank on
    4 ch x 2 time, packet for packet (channel, index, bytes, arm)."""
    import jax

    from gr4_packet_modem_tpu.models.receiver import RxConfig as JConfig
    from gr4_packet_modem_tpu.parallel.bank import make_mesh as jmake_mesh
    from gr4_packet_modem_tpu.parallel.serving import StreamingShardedBank as JSharded

    stim, refs, runs = served
    x, ch_payloads = stim["four"]
    _clean(refs["four"])
    want = sorted(map(_key, refs["four"]["packets"]))
    assert len(want) == sum(len(p) for p in ch_payloads)
    _clean(runs["f32"])
    assert sorted(map(_key, runs["f32"]["packets"])) == want
    assert len(jax.devices()) >= 8
    jbank = JSharded(jmake_mesh(8, time_shards=2), JConfig(**CFG), channels=4, block=BLOCK, group=0)
    jpkts = jbank.process(x) + jbank.flush()
    assert jbank.overflow_blocks == 0 and jbank.budget_overflow_blocks == 0
    assert sorted(_key(_record(p)) for p in jpkts) == want


@pytest.mark.timeout(600)
def test_sharded_bank_degenerate_mesh_parity(served):
    """The 1 x 1 mesh gives StreamingBank's packets in the same order, every
    field equal."""
    _, refs, runs = served
    assert len(refs["two"]["packets"]) > 0
    assert runs["one"] == refs["two"]


@pytest.mark.timeout(600)
def test_sharded_bank_compacted_wire_parity(served):
    """Compaction to 3 slots a cell leaves the packet set as it is."""
    stim, _, runs = served
    for name in ("f32", "budget3"):
        _clean(runs[name])
    keys = sorted(map(_key, runs["budget3"]["packets"]))
    assert keys == sorted(map(_key, runs["f32"]["packets"]))
    assert len(keys) == sum(len(p) for p in stim["four"][1])


@pytest.mark.timeout(600)
def test_sharded_bank_group_pipelining_matches_monolithic(served):
    """8 channels on 2 ch shards: groups of 2 within a rank equal one group
    (the chain gathers inside the group loop match across shards)."""
    _, _, runs = served
    g0, g2 = (sorted(map(_key, runs[n]["packets"])) for n in ("group0", "group2"))
    assert len(g0) > 0
    assert g0 == g2


@pytest.mark.timeout(600)
@pytest.mark.parametrize("wire", ["int8", "int4"])
def test_sharded_bank_quantized_wire(served, wire):
    """The int8 and packed int4 wires, staged per cell and gathered along
    time, decode every packet of every channel byte-exact, in order."""
    stim, _, runs = served
    _clean(runs[wire])
    ch_payloads = stim["four"][1]
    for c, pays in enumerate(ch_payloads):
        got = [bytes.fromhex(r[2]) for r in sorted(runs[wire]["packets"], key=lambda r: r[1]) if r[0] == c]
        assert got == [p.tobytes() for p in pays], f"channel {c}"


@pytest.mark.timeout(600)
def test_int4_needs_an_even_shard(served):
    """On the int4 wire each rank's slice of a block packs sample pairs: a
    block of 4098 on two time shards is refused."""
    _, _, runs = served
    assert "even" in runs["odd_int4"]
