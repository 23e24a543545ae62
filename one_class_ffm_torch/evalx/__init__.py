"""Ranking evaluation (PyTorch port)."""
