"""Build, load and launch the port's hand-written CUDA kernels.

All of ``gr4_packet_modem_tpu_torch/csrc/*.cu`` is compiled by ``nvcc`` (one
process per source, all in parallel) and linked into one shared library
with a plain C interface, at first use, for Hopper (``sm_90a``), and loaded
with ``ctypes``. The library lands in
``build/kernels/`` beside the package, under a name that hashes the sources
and the compiler flags, so an edited source is rebuilt and an unchanged one
is loaded as it is.

Every C entry point launches on the stream it is given (the wrapper passes
``torch.cuda.current_stream()``), allocates nothing, and returns
``cudaGetLastError()``; :func:`launch` raises when that is not 0 and only
then counts the launch. The counts let a run show which kernels the main
path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from .costas import costas_gains

__all__ = [
    "KERNELS", "build", "library", "launch", "launch_counts",
    "reset_launch_counts", "stream_of",
]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

KERNELS = ("fetch", "fetch_rows", "matched", "costas", "ldpc", "correlate", "correlate_bf16")

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_longlong
_F = ctypes.c_float

# argument lists of the C entry points (pointers and the stream as c_void_p:
# a bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # x, starts, outr, outi, total_len, region_len, d, blocks, stream
    "pm_fetch_regions": [_P, _P, _P, _P, _I64, _I, _I, _I, _P],
    # x, starts, out, total_len, region_len, d, blocks, stream
    "pm_fetch_rows": [_P, _P, _P, _I64, _I, _I, _I, _P],
    # ar, ai, br, bi, rf, tw, best_pow, best_bin, fpad, s, nb, log2n, stream
    "pm_correlate": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # ar, ai, br, bi, rep, fwd, inv, small, tw, best_pow, best_bin, fpad, s, nb, log2n, stream
    "pm_correlate_bf16": [_P] * 11 + [_I, _I, _I, _I, _P],
    # zr, zi, taps, outr, outi, region_len, ntaps, sps, num_syms, d, stream
    "pm_matched_filter": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # sym, out, ph0, fr0, ph_end, fr_end, b, s, offset, stream
    "pm_costas_track": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # llrs, totals, chk_vars, var_edges, b, m, dmax, n, vdeg, iters, alpha, stream
    "pm_ldpc_totals": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P],
}

_launches = dict.fromkeys(KERNELS, 0)
_lib: ctypes.CDLL | None = None


def _float_literal(v: float) -> str:
    """Exact C++ float literal (hex form) of ``v`` rounded to float32."""
    return float(np.float32(v)).hex() + "f"


def _defines() -> list[str]:
    """Compile-time constants: the Costas loop gains of the receiver's
    positional schedule, taken from ``costas_coefficients``."""
    names = ("K1A", "K2A", "K1B", "K2B", "K1C", "K2C")
    return [
        f"-DPM_COSTAS_{n}={_float_literal(v)}"
        for n, v in zip(names, costas_gains())
    ]


_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]


def _flags() -> list[str]:
    """Compile flags of every source (no fast math)."""
    return [
        *_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        *_defines(),
    ]


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libpm_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")
    return path


def build() -> Path:
    """Compile the kernels unless this exact build already exists: one
    ``nvcc -c`` per source, all started together, then one link. Returns
    the library's path; the ptxas report (registers, shared memory, spills)
    is kept beside it with the suffix ``.log``."""
    path = library_path()
    if path.exists():
        return path
    objdir = BUILD_DIR / f"{path.stem}.{os.getpid()}.objs"
    objdir.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    nvcc, sources = _nvcc(), _sources()
    objs = [str(objdir / f"{src.stem}.o") for src in sources]
    try:
        jobs = [
            subprocess.Popen(
                [nvcc, *_flags(), "-c", "-o", obj, str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [job.communicate()[0] for job in jobs]
        for src, job, log in zip(sources, jobs, logs):
            if job.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({job.returncode}):\n{log}")
        link = subprocess.run(
            [nvcc, *_ARCH, "-shared", "-o", str(tmp), *objs],
            capture_output=True, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}\n{link.stderr}")
    finally:
        shutil.rmtree(objdir, ignore_errors=True)
    path.with_suffix(".log").write_text("".join(logs))
    os.replace(tmp, path)
    return path


def build_single(source: Path) -> ctypes.CDLL:
    """Compile one CUDA source on its own, with the library's flags, into
    ``build/kernels/`` and load it: a probe (``csrc/probe/``) or another
    version of a kernel, outside the port's library. Its entry points'
    argument types are the caller's to set; its launches are not counted."""
    source = Path(source).resolve()
    h = hashlib.sha256(" ".join(_flags()).encode())
    for src in [source, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    path = BUILD_DIR / f"{source.stem}_{h.hexdigest()[:16]}.so"
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
        job = subprocess.run(
            [_nvcc(), *_flags(), "-I", str(CSRC), "-shared", "-o", str(tmp), str(source)],
            capture_output=True, text=True,
        )
        if job.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} ({job.returncode}):\n{job.stdout}\n{job.stderr}")
        path.with_suffix(".log").write_text(job.stdout + job.stderr)
        os.replace(tmp, path)
    return ctypes.CDLL(str(path))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, args in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.pm_error_string.argtypes = [_I]
        lib.pm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def stream_of(t: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(kernel: str, entry: str, device: torch.device, *args) -> None:
    """Call C entry point ``entry`` on ``device``; raise on a CUDA error,
    else count one launch of ``kernel``."""
    lib = library()
    with torch.cuda.device(device):
        status = getattr(lib, entry)(*args)
    if status != 0:
        msg = lib.pm_error_string(status).decode()
        raise RuntimeError(f"{entry}: CUDA error {status} ({msg})")
    _launches[kernel] += 1


def launch_counts() -> dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0
