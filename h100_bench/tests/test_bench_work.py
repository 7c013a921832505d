"""The work counts reproduce the kernel bounds the port's records give
(PERF.md's table of kernels) at the bench shapes."""

import pytest

from h100_bench import work


def test_k1_float32_term_at_the_bench_bank():
    # FPAD 20,480 frames, N 2048, 9 bins: 0.2943 ms of float32 operations
    ms = work.correlation_ops(20480, 2048, 9) / work.PEAK_F32_PER_S * 1e3
    assert ms == pytest.approx(0.2943, abs=5e-5)


def test_k4_bytes_at_the_payload_pass():
    # 1536 rows of 6160 symbols: 0.0452 ms of bytes
    ms = work.least_s(work.costas_bytes(1536, 6160), 0) * 1e3
    assert ms == pytest.approx(0.0452, abs=5e-5)


def test_acquire_counts_the_frames_overlap_save_needs():
    # 64 channels of 553,396 samples, stride 2048 - 297 + 1: 315 frames each
    nbytes, ops = work.acquire_work(64, 553396, 2048, 297, 9, 24)
    assert ops == work.correlation_ops(64 * 315, 2048, 9)
    assert nbytes >= 64 * 553396 * 8
    assert work.least_s(nbytes, ops) == ops / work.PEAK_F32_PER_S
