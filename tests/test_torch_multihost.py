"""Two OS processes brought up by ``parallel.multihost.initialize()`` from
the ``PM_*`` variables (gloo), after tests/test_multihost.py: a 1 ch x 2
time mesh across the processes, two channels, channel 1's packet across the
cross-process shard edge; both packets are accepted. In the same processes:
``measure_scaling`` at world 2, and ``entry.sharded_dryrun`` on the 1 x 2
mesh. ``initialize()`` without ``PM_COORDINATOR`` starts nothing.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

from gr4_packet_modem_tpu_torch.entry import sharded_dryrun  # noqa: E402
from gr4_packet_modem_tpu_torch.models.receiver import RxConfig  # noqa: E402
from gr4_packet_modem_tpu_torch.parallel import multihost  # noqa: E402
from gr4_packet_modem_tpu_torch.parallel.bank import BankConfig, ReceiverBank, make_mesh  # noqa: E402
from test_torch_parallel import burst, packets_of, start_ranks, wait_ranks  # noqa: E402

BLOCK = 4096
RXCFG = RxConfig(max_payload_len=64, max_detections=4, freq_bins=1)
PAYLOAD = np.arange(48, dtype=np.uint8)


def _signal() -> np.ndarray:
    """Channel 0's packet at 100, channel 1's across the edge at 4096."""
    b = burst(PAYLOAD, 64)
    x = np.zeros((2, 2 * BLOCK), np.complex64)
    x[0, 100 : 100 + b.size] = b
    straddle = BLOCK - b.size // 2
    x[1, straddle : straddle + b.size] = b
    return x


def _rank_main(rank: int, world: int, store: str, out_dir: str) -> None:
    os.environ.update(PM_COORDINATOR=f"file://{store}", PM_NUM_PROCESSES=str(world),
                      PM_PROCESS_ID=str(rank))
    torch.set_num_threads(1)
    if not multihost.initialize(device_type="cpu", timeout_s=120):
        raise AssertionError("PM_COORDINATOR was set")
    if "jax" in sys.modules:
        raise AssertionError("a rank imported jax")
    out = {"world": dist.get_world_size(), "rank": dist.get_rank()}
    mesh = make_mesh(2, time_shards=2, device_type="cpu")
    bank = ReceiverBank(mesh, BankConfig(rx=RXCFG))
    x = _signal()
    res = bank.step(torch.from_numpy(np.ascontiguousarray(bank.local_slice(x))))
    n = res.accepted.sum()
    dist.all_reduce(n)
    out["accepted"] = int(n)
    out["packets"] = [[p.hex() for p in packets_of(res.accepted[c].numpy(), res.lengths[c].numpy(),
                                                     res.data[c].numpy())] for c in range(2)]
    out["scaling"] = multihost.measure_scaling(x[1], device_counts=(1, 2, 2), channels_per_device=2,
                                               iters=1, rx_config=RXCFG, device_type="cpu")
    out["dryrun"] = sharded_dryrun(make_mesh(device_type="cpu"), "cpu")
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("multihost")
    wait_ranks(start_ranks(_rank_main, 2, tmp, str(tmp)), timeout=400)
    outs = []
    for r in range(2):
        with open(tmp / f"rank{r}.json") as f:
            outs.append(json.load(f))
    return outs


@pytest.mark.timeout(600)
def test_two_process_distributed_bank(two_processes):
    """Both packets accepted over the two processes; channel 1's packet,
    which starts in process 0's shard, decodes there through the right
    halo taken from process 1."""
    for r, out in enumerate(two_processes):
        assert (out["world"], out["rank"]) == (2, r)
        assert out["accepted"] == 2
    p0, p1 = (out["packets"] for out in two_processes)
    assert p0 == [[PAYLOAD.tobytes().hex()]] * 2
    assert p1 == [[], []]


def test_initialize_without_coordinator(monkeypatch):
    monkeypatch.delenv("PM_COORDINATOR", raising=False)
    assert multihost.initialize(device_type="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.timeout(600)
def test_measure_scaling_points(two_processes):
    """Points 1 and 2 (the repeated 2 skipped) on rank 0, efficiency 1 at
    the first; the other rank returns None."""
    scaling = two_processes[0]["scaling"]
    assert [p["devices"] for p in scaling] == [1, 2]
    assert scaling[0]["efficiency"] == 1.0
    assert all(p["samples_per_sec"] > 0 and p["per_chip"] > 0 for p in scaling)
    assert two_processes[1]["scaling"] is None


@pytest.mark.timeout(600)
def test_sharded_dryrun_one_by_two(two_processes):
    """The dry run's gates hold on the 1 x 2 mesh: 1536- and 700-byte
    packets straddling the time shards through the int8 wire, and the
    bank's packet."""
    for out in two_processes:
        assert out["dryrun"] == {"packets": 2, "bank_accepted": 1}
