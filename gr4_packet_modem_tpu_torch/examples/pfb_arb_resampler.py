"""Polyphase arbitrary resampler: impose a sampling-frequency offset on a
tone and measure that its frequency scales by the rate (port of
examples/pfb_arb_resampler.py; pfb_arb_resampler.hpp's 32-arm bank).

usage: python -m gr4_packet_modem_tpu_torch.examples.pfb_arb_resampler [--device DEV]
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.channel import sfo
from . import check, parse

FREQ = 0.01  # cycles/sample
PPM = 2000.0


def run(argv: list[str] | None = None, *, echo=print) -> dict:
    """Returns the ``measured`` and ``expected`` tone (cycles/sample)."""
    _, dev = parse(argv, "pfb_arb_resampler")
    n = 1 << 14
    t = np.arange(n)
    x = np.exp(2j * np.pi * FREQ * t).astype(np.complex64)
    y = sfo(torch.as_tensor(x, device=dev), ppm=PPM, num_out=n - 64).cpu().numpy()

    # the output tone's frequency: FFT peak with quadratic refinement
    win = np.hanning(y.size)
    spec = np.abs(np.fft.fft(y * win))
    k = int(np.argmax(spec))
    a, b, c = spec[k - 1], spec[k], spec[k + 1]
    delta = 0.5 * (a - c) / (a - 2 * b + c)
    f_meas = (k + delta) / y.size
    expect = FREQ / (1.0 + PPM * 1e-6)
    echo(f"input tone {FREQ:.6f}, rate 1+{PPM}ppm -> expect {expect:.6f}, "
         f"measured {f_meas:.6f}")
    check(abs(f_meas - expect) < 5e-6, f"measured {f_meas} against {expect}")
    check(abs(f_meas - FREQ) > 1e-5, "the SFO is not visible")
    return {"measured": float(f_meas), "expected": expect}


def main() -> None:
    run()


if __name__ == "__main__":
    main()
