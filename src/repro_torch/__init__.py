"""PyTorch/CUDA port of the LCC compression system (serving slice).

Sits beside the JAX package ``repro`` and mirrors its sub-package names.  It
imports ``torch`` and numpy only — never ``jax`` and nothing of ``repro``.
Every entry point takes ``device=`` and defaults to the GPU; compressed
projections run through CUDA kernels written for Hopper
(``repro_torch.kernels``) whenever their input lies on a CUDA device.
"""
