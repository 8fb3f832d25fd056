"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It mirrors the JAX package's layout (``fabric``, ``core``, ``db``,
``kernels``, ``configs``) and imports nothing of it.  Entry points run on
the card unless the caller passes ``device="cpu"``; the hand-written
kernels live in ``kernels/csrc`` and are built with ``nvcc`` at first use.
"""
