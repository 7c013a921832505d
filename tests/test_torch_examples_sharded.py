"""The port's mesh examples (``receiver_bank_serving``, ``sharded_bank``,
``sharded_serving``) on four spawned gloo ranks, a 2 ch x 2 time mesh,
against the JAX examples on four virtual CPU devices, the same mesh shape
(each in a subprocess with ``PM_PLATFORM=cpu`` and the device-count flag
at 4; the conftest's 8 would make a 4 x 2 mesh).

One spawn serves the three examples (``examples/_mesh.spawn``, the
launcher behind ``--world``); the JAX subprocesses run meanwhile. Held
to: the same mesh shape, channel count, total and per-channel packet
counts, and the same mesh line; ``receiver_bank_serving``'s rate lines
are timing and are not compared. Without a process group, ``run()``
hands ``--world`` ranks to the launcher.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gr4_packet_modem_tpu_torch.examples import MESH_EXAMPLES, _mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# runs an unchanged JAX example and prints what it computed as one JSON line
_JAX_SIDE = r"""
import json, runpy, sys
import numpy as np
name = sys.argv[1]
g = runpy.run_path(f"examples/{name}.py", run_name="__main__")
mesh = [int(n) for n in g["mesh"].devices.shape]
if name == "sharded_serving":
    per_ch = np.bincount([p.channel for p in g["pkts"]], minlength=g["channels"])
elif name == "sharded_bank":
    per_ch = g["accepted"].reshape(g["channels"], -1).sum(axis=1)
else:
    per_ch = g["per_ch"]
print("JSON " + json.dumps({"mesh": mesh, "channels": int(g["channels"]),
                            "per_channel": np.asarray(per_ch).tolist()}))
"""


@pytest.fixture(scope="module")
def both():
    env = dict(os.environ, PM_PLATFORM="cpu", JAX_PLATFORMS="cpu", JAX_CACHE_DIR="",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_runs = {
        name: subprocess.Popen([sys.executable, "-c", _JAX_SIDE, name], cwd=ROOT, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in MESH_EXAMPLES
    }
    try:
        lines = []
        jobs = [(f"gr4_packet_modem_tpu_torch.examples.{name}", ["--device", "cpu"]) for name in MESH_EXAMPLES]
        port = dict(zip(MESH_EXAMPLES, _mesh.spawn(jobs, 4, "cpu", echo=lines.append)))
        jax = {}
        for name, proc in jax_runs.items():
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            printed = out.splitlines()
            jax[name] = dict(json.loads(printed[-1][5:]), lines=printed[:-1])
    finally:
        for proc in jax_runs.values():
            proc.kill()
    return port, jax, lines


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", MESH_EXAMPLES)
def test_mesh_example_matches_jax(both, name):
    port, jax, lines = both
    got, want = port[name], jax[name]
    assert list(got["mesh"]) == want["mesh"] == [2, 2]
    assert got["channels"] == want["channels"]
    assert got["per_channel"] == want["per_channel"]
    assert got["decoded"] == sum(want["per_channel"]) == sum(got["per_channel"])
    assert want["lines"][0] in lines  # the mesh line, as JAX prints it
    assert len(got["rank_launches"]) == 4  # every rank reported (no kernel runs on the CPU)


@pytest.mark.timeout(900)
def test_rank_zero_lines_echoed(both):
    _, jax, lines = both
    for name in ("sharded_bank", "sharded_serving"):
        assert jax[name]["lines"][-1] in lines
    assert "OK" in lines


def test_run_without_a_group_spawns_world_ranks(monkeypatch):
    from gr4_packet_modem_tpu_torch.examples import sharded_bank

    calls = []
    monkeypatch.delenv("PM_COORDINATOR", raising=False)
    monkeypatch.setattr(_mesh, "spawn", lambda *a, **k: calls.append((a, k)) or [{"spawned": True}])
    argv = ["--device", "cpu", "--world", "3"]
    assert sharded_bank.run(argv) == {"spawned": True}
    (args, _), = calls
    assert args[:3] == ([("gr4_packet_modem_tpu_torch.examples.sharded_bank", argv)], 3, "cpu")
