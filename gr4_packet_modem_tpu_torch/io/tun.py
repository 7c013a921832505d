"""TUN device IO via the native helper library (ctypes).

Port of ``gr4_packet_modem_tpu/io/tun.py``, with the same ctypes API:
IP packets enter and leave the modem through a Linux TUN device, optionally
inside a named network namespace (tun_source.hpp:15-153, tun_sink.hpp:15-44,
tun.hpp:28-57). The native library is the repo's own ``native/tunio.cpp``
(the fd plumbing and a lock-free SPSC ring buffer), compiled here with
``g++`` and ``native/Makefile``'s flags into ``build/native/libpmtun.so``;
nothing under ``native/`` is written. A failed build raises with the
compiler's message.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

__all__ = ["native_lib", "TunDevice", "build_native"]

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "tunio.cpp"
_LIB_PATH = _ROOT / "build" / "native" / "libpmtun.so"
# native/Makefile: CXXFLAGS and the shared-library rule
_CXXFLAGS = ["-O2", "-Wall", "-Wextra", "-std=c++20", "-fPIC"]
_lib = None


def build_native() -> Path:
    """Compile ``native/tunio.cpp`` into ``build/native/libpmtun.so``
    unless the library is there and newer than the source. Returns its
    path; raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    if not _SOURCE.exists():
        raise RuntimeError(f"native IO source missing: {_SOURCE}")
    if _LIB_PATH.exists() and _LIB_PATH.stat().st_mtime >= _SOURCE.stat().st_mtime:
        return _LIB_PATH
    _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        job = subprocess.run(
            [cxx, *_CXXFLAGS, "-shared", "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
    except OSError as e:
        raise RuntimeError(f"native IO build: cannot run {cxx}: {e}") from e
    if job.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"native IO build failed ({cxx}, exit {job.returncode}):\n{job.stdout}{job.stderr}"
        )
    os.replace(tmp, _LIB_PATH)
    return _LIB_PATH


def native_lib():
    """Load (building if needed) the native IO library."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build_native()))
    lib.pm_tun_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.pm_tun_open.restype = ctypes.c_int
    lib.pm_read_timeout.argtypes = [
        ctypes.c_int, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
    ]
    lib.pm_read_timeout.restype = ctypes.c_int
    lib.pm_write.argtypes = [ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.pm_write.restype = ctypes.c_int
    lib.pm_close.argtypes = [ctypes.c_int]
    lib.pm_close.restype = ctypes.c_int
    lib.pm_ring_create.argtypes = [ctypes.c_size_t]
    lib.pm_ring_create.restype = ctypes.c_void_p
    lib.pm_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.pm_ring_write.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.pm_ring_write.restype = ctypes.c_size_t
    lib.pm_ring_read.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
    ]
    lib.pm_ring_read.restype = ctypes.c_size_t
    lib.pm_ring_readable.argtypes = [ctypes.c_void_p]
    lib.pm_ring_readable.restype = ctypes.c_size_t
    _lib = lib
    return _lib


class TunDevice:
    """A TUN device for IP packet ingress/egress.

    Needs root (CAP_NET_ADMIN); see scripts/netns-setup in the reference for
    the namespace topology this mirrors.
    """

    MAX_PACKET = 65535

    def __init__(self, name: str = "tun0", netns: str = ""):
        lib = native_lib()
        self._lib = lib
        self.fd = -1
        fd = lib.pm_tun_open(name.encode(), netns.encode())
        if fd < 0:
            raise OSError(-fd, os.strerror(-fd), f"tun {name} netns={netns!r}")
        self.fd = fd
        self._buf = ctypes.create_string_buffer(self.MAX_PACKET)

    def read_packet(self, timeout_ms: int = 100) -> bytes | None:
        """Read one IP packet; None on timeout."""
        n = self._lib.pm_read_timeout(
            self.fd, self._buf, self.MAX_PACKET, timeout_ms
        )
        if n < 0:
            raise OSError(-n, os.strerror(-n))
        if n == 0:
            return None
        return self._buf.raw[:n]

    def write_packet(self, packet: bytes) -> int:
        """Write one IP packet; errors are tolerated (returns <0 errno) the
        way TunSink tolerates malformed decoder output (tun_sink.hpp:33-37)."""
        return self._lib.pm_write(self.fd, packet, len(packet))

    def close(self):
        if self.fd >= 0:
            self._lib.pm_close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
