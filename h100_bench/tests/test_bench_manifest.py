"""BENCHMARK.json and the files it names: every cell's configuration,
traffic mix, entry driver and metric readers (the staged cells' too) are
found by name, and each reader declares what the manifest says of it."""

import json
import re

from h100_bench import guard
from h100_bench.run import applies, load_module

from .conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_names_and_keys(bench_manifest):
    manifest = bench_manifest
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                             "per_layer"}
    assert manifest["paths"] == ["h100_bench"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in manifest[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= 1
    assert any(m["name"] == "setup_s" for m in manifest["end_to_end"])
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 << 10


def test_every_cell_finds_its_files(manifest):
    configs = {c["name"]: c for c in manifest["configs"]}
    for w in manifest["workloads"]:
        cfg = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert cfg["source"] == configs[w["config"]]["source"]
        assert cfg["reduced"] == configs[w["config"]]["reduced"]
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        entry = load_module(BENCH / "entries" / f"{mix['entry']}.py")
        assert all(hasattr(entry, f) for f in ("setup", "window", "check"))
        assert set(cfg["limits"][mix["entry"]]) >= {"missed", "false", "dup"}
        e2e = [m for m in manifest["end_to_end"] if applies(m, w["name"], set())]
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
        per_layer = [m for m in manifest["per_layer"] if applies(m, w["name"], {m["name"] for m in e2e})]
        assert per_layer


def test_metric_files_declare_what_the_manifest_says(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        mod = load_module(BENCH / "metrics" / f"{m['name']}.py")
        assert (mod.UNIT, mod.SOURCE) == (m["unit"], m["source"]), m["name"]
        assert mod.MOVES == m.get("moves"), m["name"]
        if "layer" in m:
            assert mod.LAYER == m["layer"], m["name"]


def test_no_forbidden_import_and_reference_stands_alone():
    assert guard.reference_violations() == []
    assert guard.loaded_forbidden({"jax.numpy": 1, "gr4_packet_modem_tpu.ops": 1, "jaxlib": 1}) == [
        "gr4_packet_modem_tpu.ops", "jax.numpy", "jaxlib"]
    assert guard.loaded_forbidden({"gr4_packet_modem_tpu_torch.ops": 1, "jaxtyping": 1}) == []
    for f in BENCH.rglob("*.py"):
        assert not guard.imported_top_levels(f) & guard.FORBIDDEN, f
