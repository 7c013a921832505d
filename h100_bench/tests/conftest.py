"""A tiny copy of the benchmark's data files for the CPU tests: the same
configurations and mixes cut to two channels of 2^16 samples, two banks,
three payloads and eight detection slots; and the manifest with the
staged cells added."""

import copy
import json
import shutil
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# Cells whose files are here but that BENCHMARK.json does not carry (PERF.md,
# Open questions, says why): the tests drive them all the same.
STAGED = {
    "workloads": [
        {"name": "vv8_stream", "config": "rx_vv", "traffic": "stream_int8_8ch", "chips": 1, "why": "staged"},
        {"name": "vv64_stream_4card", "config": "rx_vv", "traffic": "stream_int8_64ch", "chips": 4,
         "why": "staged"},
    ],
    "end_to_end": [
        {"name": "stream_sps", "unit": "samples/s", "better": "higher", "bound": 0.25, "source": "host_clock",
         "workloads": ["vv8_stream", "vv64_stream_4card"]},
    ],
    "per_layer": [
        {"name": n, "unit": "ms", "better": "lower", "source": "program_span", "layer": "streaming drivers",
         "moves": "stream_sps", "workloads": ["vv8_stream", "vv64_stream_4card"]}
        for n in ("stream_h2d_ms", "stream_dispatch_ms")
    ] + [
        {"name": "idle_pct.stream", "unit": "%", "better": "lower", "source": "device_trace", "layer": "device",
         "moves": "stream_sps", "workloads": ["vv8_stream", "vv64_stream_4card"]},
        {"name": "nccl_ms.stream", "unit": "ms", "better": "lower", "source": "device_trace",
         "layer": "multi-card", "moves": "stream_sps", "workloads": ["vv64_stream_4card"]},
    ],
}


def tiny_bench(dst: Path) -> Path:
    for d in ("configs", "traffic", "entries", "metrics"):
        shutil.copytree(BENCH / d, dst / d)
    for f in (dst / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["block"] = 1 << 16
        c["rx"]["max_detections"] = 8
        f.write_text(json.dumps(c))
    for f in (dst / "traffic").glob("*.json"):
        m = json.loads(f.read_text())
        m.update(channels=2, blocks=2, pool=3)
        f.write_text(json.dumps(m))
    return dst


@pytest.fixture
def bench_dir(tmp_path):
    return tiny_bench(tmp_path / "bench")


@pytest.fixture(scope="session")
def bench_manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(scope="session")
def manifest(bench_manifest):
    """BENCHMARK.json with the staged cells and their metrics added."""
    m = copy.deepcopy(bench_manifest)
    for key, entries in STAGED.items():
        m[key] += copy.deepcopy(entries)
    next(e for e in m["end_to_end"] if e["name"] == "latency_p95_ms")["workloads"].append("vv8_stream")
    return m
