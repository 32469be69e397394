"""PyTorch + CUDA port of the wavefront fur path tracer.

Mirrors the module layout of `ba_pathtracing_fur_tpu` (the JAX/Pallas
reference): the counterpart of `ba_pathtracing_fur_tpu/X/y.py` is
`ba_pathtracing_fur_torch/X/y.py`. This package imports torch and never
jax. Every hand-written kernel lives in `csrc/`, is built on first use by
`kernels/`, and has a plain-torch twin beside its wrapper that runs on CPU
tensors.
"""

__version__ = "0.1.0"
