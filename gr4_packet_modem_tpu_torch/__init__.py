"""PyTorch + CUDA port of the packet modem receive chain and its streaming
drivers.

The JAX package ``gr4_packet_modem_tpu`` is the reference this package is
held against; the module layout mirrors it (``ops/``, ``models/``,
``runtime/``, ``utils/``). Plain tensor code is PyTorch, and each Pallas
kernel of the JAX package has a hand-written CUDA counterpart under
``csrc/``, built with
``nvcc`` at first use (``ops/_build.py``). On CPU tensors every kernel
wrapper runs its plain PyTorch version instead.
"""

__version__ = "0.1.0"
