"""one_class_ffm_torch — the PyTorch/CUDA port of one_class_ffm_tpu.

The JAX package beside it is the reference; this package imports its
framework-free host code (data, block layout, hyperparameters, oracle,
numpy metrics, trainer configuration and file formats) and never imports
``jax``.  It runs one-class MF, FM and FFM end to end on one device, with or
without self blocks, on identity id fields and feature fields of at most
4096 features (``solver.torch_solver.FUSED_TBL_D``): the stream and table
passes of each solve are hand-written CUDA kernels for Hopper (``csrc/``),
with plain PyTorch versions beside them for the CPU.

Layout:
  ops/      blocked layout (numpy), plain ops, kernel build and launch
  csrc/     CUDA C++ kernels (sm_90a)
  solver/   Gauss-Newton/CG block solver, parameter conversion
  evalx/    full-catalog ranking evaluation
  train.py  trainer;  cli.py  command line
"""

__version__ = "0.1.0"
