"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell comes from ``BENCHMARK.json`` at the root of the checkout; its
configuration, traffic mix, entry driver and metric readers are files of
this package found by name. The run sets up the program (set-up ends at
the first timed block), measures for ``--seconds``, frees the program's
state, checks the outputs against the plain reference, and prints the
compared numbers with their limits as the last lines of standard error,
then one JSON line as the last line of standard output. With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics and the device's busy time and the trace's breakdown.

Set-up ends with a garbage collection and ``gc.freeze()``, so that the
collector's later passes in the window scan what the window makes and
not the modules and tables of the set-up. A run that had to build the
port's kernel library with nvcc reports the build's seconds apart, under
``build_s`` in the result line and on standard error; ``setup_s`` holds
them, as the set-up of a run that compiles.

The command runs from the root of a checkout of the repository, where
``BENCHMARK.json`` and the port's package lie. It exits with 2 and prints
no result where there is no CUDA card or fewer cards than the cell asks
for, or where the port's package is not there (a directory that holds
only ``BENCHMARK.json`` and this package), and with 3 where a module of
JAX or of the JAX package is loaded after the window.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def process_start() -> float:
    """``time.perf_counter()`` at the moment this process started (from
    ``/proc``), or now where ``/proc`` cannot tell."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return now - max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


def pin_caches(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only a checkout's first run builds (the port's own kernel
    library already lives in ``build/kernels/``)."""
    cache = root / "build" / "h100_bench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_module(path: Path):
    """Import the Python file ``path`` as a module of its own (the
    entries' and metrics' files are found by name, and a metric's name may
    hold dots)."""
    name = "h100_bench._loaded." + path.stem.replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Ctx:
    """What a run's entry driver is given. ``mark(name)`` notes the time
    since the process started, for the set-up's split on standard error."""

    torch: object
    device: object
    seed: int
    trace: bool
    config: dict
    mix: dict
    t_start: float
    hooks: dict = field(default_factory=dict)
    record: dict = field(default_factory=dict)
    marks: list = field(default_factory=list)

    def mark(self, name: str) -> None:
        self.marks.append(f"{name} {time.perf_counter() - self.t_start:.3f}")


def applies(metric: dict, cell: str, reported: set[str]) -> bool:
    """Whether a metric is reported in ``cell``: those that list cells, in
    the cells they list; a per-layer metric that lists none, in every cell
    that reports the end-to-end metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def run_cell(manifest: dict, name: str, seed: int, seconds: float, trace: bool, device,
             bench_dir: Path = HERE, t_start: float | None = None, hooks: dict | None = None) -> tuple[dict, list]:
    """Run cell ``name`` once on ``device``. Returns ``(result line,
    [(number, value, limit)])``. ``bench_dir`` holds ``configs/``,
    ``traffic/``, ``entries/`` and ``metrics/``; ``hooks`` reach the entry
    (the CPU tests plant faults through them)."""
    import torch

    from . import guard

    t_start = time.perf_counter() if t_start is None else t_start
    cell = next(w for w in manifest["workloads"] if w["name"] == name)
    config = json.loads((bench_dir / "configs" / f"{cell['config']}.json").read_text())
    config["rx"].update((hooks or {}).get("rx", {}))
    mix = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    entry = load_module(bench_dir / "entries" / f"{mix['entry']}.py")
    guard.check("start")
    ctx = Ctx(torch, device, seed, trace, config, mix, t_start, hooks or {})
    rec = ctx.record
    if device.type == "cuda":
        from gr4_packet_modem_tpu_torch.ops import _build

        if not _build.library_path().exists():
            t = time.perf_counter()
            _build.library()
            rec["build_s"] = time.perf_counter() - t
    ctx.mark("imports")
    state = entry.setup(ctx)
    gc.collect()
    gc.freeze()
    rec["setup_s"] = time.perf_counter() - t_start
    if "build_s" in rec:
        print(f"h100_bench: this set-up ({rec['setup_s']:.3f} s) built the kernel library with nvcc "
              f"in {rec['build_s']:.3f} s", file=sys.stderr)
    entry.window(ctx, state, seconds)
    t_check = time.perf_counter()
    on_cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_cuda else 0
    rec.setdefault("memory_peak_bytes", peak)
    numbers = entry.check(ctx, state)
    del state
    gc.unfreeze()
    print(f"h100_bench: set-up {rec['setup_s']:.3f} s ({', '.join(ctx.marks)}), "
          f"window {rec['window_s']:.3f} s, check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    checks = [(k, numbers[k], float(v)) for k, v in config["limits"][mix["entry"]].items()]
    found = guard.loaded_forbidden()
    if found:
        raise ForbiddenLoaded(found)

    e2e = [m for m in manifest["end_to_end"] if applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    chosen = (e2e if not trace else
              [m for m in manifest["per_layer"] if applies(m, name, reported)])
    metrics = {}
    for m in chosen:
        value = load_module(bench_dir / "metrics" / f"{m['name']}.py").read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if on_cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if on_cuda else device.type,
        "count": int(cell["chips"]),
        "memory_peak_bytes": int(rec["memory_peak_bytes"]),
    }
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(numbers["expected"]),
        "failed": int(numbers["missed"] + numbers["false"] + numbers["dup"]),
        "metrics": metrics,
        "device": dev_info,
    }
    if "build_s" in rec:
        result["build_s"] = rec["build_s"]
    if trace:
        prof = rec.get("profile") or {}
        dev_info["busy_s"] = prof.get("busy_s", 0.0)
        dev_info["window_s"] = prof.get("window_s", 0.0)
        if prof:
            result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    return result, checks


class ForbiddenLoaded(RuntimeError):
    pass


def main(argv: list[str] | None = None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(prog="python3 -m h100_bench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in manifest["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"h100_bench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    pin_caches(ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"h100_bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("gr4_packet_modem_tpu_torch") is None:
        print("h100_bench: the port's package gr4_packet_modem_tpu_torch is not here; "
              "run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(manifest, args.workload, args.seed, args.seconds,
                                  bool(args.trace), torch.device("cuda", 0), t_start=t_start)
    except ForbiddenLoaded as e:
        print(f"h100_bench: modules of JAX or the JAX package loaded: {e.args[0][:20]}", file=sys.stderr)
        return 3
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
