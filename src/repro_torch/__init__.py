"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

Same sub-package names as the JAX reference (``configs``, ``kernels``,
``models``, ``core``, ``serving``, ``launch``). Imports ``torch`` and
``numpy`` only; it never imports ``jax`` or anything from ``repro``.
"""
