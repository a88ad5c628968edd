"""dynamo-tpu on PyTorch and CUDA: the serving stack of ``dynamo_tpu`` for an
NVIDIA Hopper card.

The package stands alone beside the JAX package it was ported from: it imports
``torch``, ``numpy`` and the standard library, and keeps its own copy of every
host module it needs. The one attention kernel of the main path is CUDA C++
for ``sm_90a`` (``csrc/``), built with ``nvcc`` at first use and bound with
``ctypes`` (``ops/_build.py``). Entry points run on ``cuda`` unless the caller
asks for the CPU, where each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
