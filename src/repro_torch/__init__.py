"""PyTorch/CUDA port of `repro` for NVIDIA Hopper (H100).

The layout mirrors `repro` module for module (common, configs, core,
kernels, models, serving, launch) so each module's JAX counterpart is easy
to find. The package imports torch and never jax or `repro`; only the
parity tests import both.

Entry points run on `cuda` unless the caller passes `device="cpu"`. On a
CPU tensor every kernel wrapper takes its plain PyTorch version; on a CUDA
tensor it launches the hand-written kernel or raises.
"""
