"""PyTorch/CUDA port of the DNNAbacus reproduction.

A second package beside the JAX reference ``repro``, with the same module
layout: each module here has one reference module it must agree with. It
imports ``torch`` and numpy, never JAX and nothing of ``repro``.
"""
