"""gava_clip_tpu_torch — the PyTorch / CUDA port of gava_clip_tpu.

The JAX package beside it stays the reference: every module here keeps the
name of its JAX counterpart and is held against it by the CPU parity tests
(tests/test_torch_*.py). Hot kernels are written by hand for Hopper
(`csrc/`, built with nvcc at first use); on a CPU tensor each kernel wrapper
runs its plain PyTorch version instead.

This package imports torch and never jax.
"""

__version__ = "0.1.0"
