"""The repo's examples on the PyTorch port (ports of ``examples/*.py``).

Each example runs as ``python -m gr4_packet_modem_tpu_torch.examples.<name>``
with the command line of its JAX counterpart plus ``--device`` (default
``cuda``; a missing card raises, nothing falls back to the CPU). Each has
``run(argv=None, *, echo=print) -> dict``: it does what the JAX example
does at its sizes and constants, prints the JAX example's lines through
``echo`` and returns what it printed or checked. ``main()`` runs it on
``sys.argv``. Nothing runs at import. The JAX example's ``assert``s are
checks that raise under ``python -O`` too.

Noise comes from a ``torch.Generator`` seeded as the JAX example seeds its
``jax.random`` key, so a noisy example matches its JAX counterpart in
outcome, not sample by sample.

The mesh examples (``receiver_bank_serving``, ``sharded_bank``,
``sharded_serving``) run on ``torch.distributed``: ``run()`` runs on every
rank of an initialised process group (one is started from
``PM_COORDINATOR`` / ``PM_NUM_PROCESSES`` / ``PM_PROCESS_ID`` when those are
set, ``parallel/multihost.initialize``); with neither, it spawns
``--world N`` local ranks (default 1: one card on a 1 x 1 mesh; NCCL on
the cards, gloo for ``--device cpu``) and returns rank 0's result
(``_mesh.py``).
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..apps import split_device_arg
from ..utils.device import require_device

__all__ = ["EXAMPLES", "MESH_EXAMPLES", "parse", "check"]

EXAMPLES = (
    "crc", "header_formatter", "header_roundtrip", "loopback", "messages",
    "minimal_flowgraph", "pack_bits", "packet_ingress", "packet_to_stream",
    "per_sweep", "pfb_arb_resampler", "qpsk_modulator", "receiver_bank_serving",
    "sharded_bank", "sharded_serving", "stream_pdu_domains", "streaming_blocks",
    "syncword_detection", "tun_loopback",
)
MESH_EXAMPLES = ("receiver_bank_serving", "sharded_bank", "sharded_serving")


def parse(
    argv: list[str] | None, prog: str, parser: argparse.ArgumentParser | None = None
) -> tuple[argparse.Namespace, torch.device]:
    """Take ``--device`` out of ``argv`` (``sys.argv[1:]`` when None) and
    parse the rest with ``parser`` (one that takes no arguments when None).
    Returns the arguments and the device; a CUDA device without a card
    raises."""
    argv = sys.argv[1:] if argv is None else list(argv)
    rest, name = split_device_arg(argv)
    p = parser or argparse.ArgumentParser(prog=f"python -m {__name__}.{prog}")
    return p.parse_args(rest), require_device(name)


def check(cond, msg: str) -> None:
    """The JAX example's ``assert``, raising under ``python -O`` too."""
    if not cond:
        raise AssertionError(msg)
