"""The control on the card: the program with its own lower-precision
acquisition (``fused_bf16``: K1's bf16 form) in place of the float32 one
comes out not correct, while the program as configured comes out
correct, at a size a test run holds (two channels of 2^16 samples). The
cells' own sizes are read by ``python3 -m h100_bench.calibrate ... --rx
acquisition_backend=fused_bf16`` (PERF.md gives the readings). Run on the
card: ``python3 -m pytest h100_bench/tests -m cuda``."""

import pytest
import torch

from h100_bench.run import pin_caches, run_cell

from .conftest import ROOT


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    pin_caches(ROOT)
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["vv64_dense", "costas64_dense", "vv8_stream"])
@pytest.mark.parametrize("seed", [5, 2**32 + 7, 2**31 + 11])
def test_control_fails_and_program_passes(manifest, bench_dir, card, cell, seed):
    ok, _ = run_cell(manifest, cell, seed, 1.0, False, card, bench_dir=bench_dir)
    assert ok["correct"], ok["checks"]
    ctl, _ = run_cell(manifest, cell, seed, 1.0, False, card, bench_dir=bench_dir,
                      hooks={"rx": {"acquisition_backend": "fused_bf16"}})
    assert not ctl["correct"], ctl["checks"]
