"""one_class_ffm_torch — the PyTorch/CUDA port of one_class_ffm_tpu.

The JAX package beside it is the reference; this package imports its
framework-free host code (data, block layout, hyperparameters, oracle,
numpy metrics, trainer configuration and file formats) and never imports
``jax``.  The first slice runs one-class MF with ``--ns`` end to end: the
three blocked stream passes of each solve are hand-written CUDA kernels for
Hopper (``csrc/``), with plain PyTorch versions beside them for the CPU.

Layout:
  ops/      blocked layout (numpy), plain ops, kernel build and launch
  csrc/     CUDA C++ kernels (sm_90a)
  solver/   Gauss-Newton/CG block solver, parameter conversion
  evalx/    full-catalog ranking evaluation
  train.py  trainer;  cli.py  command line
"""

__version__ = "0.1.0"
