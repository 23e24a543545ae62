"""Gauss-Newton/CG block solver (PyTorch port)."""
