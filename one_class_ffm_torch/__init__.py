"""one_class_ffm_torch — the PyTorch/CUDA port of one_class_ffm_tpu.

The JAX package beside it is the reference.  This package imports neither
``jax`` nor any module of the JAX package: it keeps its own copies of the
framework-free host code it needs (data, block layout, hyperparameters,
oracle, numpy metrics, trainer configuration and file formats).  It runs
one-class MF, FM and FFM end to end on one device, with or without self
blocks, on identity id fields and on feature fields of any width: the
stream, table and projection passes of each solve are hand-written CUDA
kernels for Hopper (``csrc/``), with plain PyTorch versions beside them
for the CPU.  It serves a saved model (``predict``: every projection on
the projection kernel, a tie-exact full-catalog top-K).

Layout:
  data/     text reader, padded views, synthetic data (copies)
  models/   field-pair block bookkeeping (copy)
  ops/      blocked layout and feature-major lists (numpy), plain ops,
            kernel build and launch
  csrc/     CUDA C++ kernels (sm_90a)
  solver/   Gauss-Newton/CG block solver, parameter conversion,
            hyperparameters and the fp64 oracle (copies)
  evalx/    full-catalog ranking evaluation, numpy metrics (copy)
  utils/    phase timer (copy), torch.profiler traces, device choice
  train.py  trainer;  cli.py  command line
  predict.py      scorer / top-K predictor of a saved model (serving)
  serve_bench.py  serving throughput: full-catalog scoring + top-K
  entry.py        the scoring step with example arguments
  sweep.py, logtools.py  sweep runner and log tools (copies)
  parity.py       metric parity against the C++ reference binary
"""

__version__ = "0.1.0"
