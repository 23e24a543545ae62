"""The device a run's tensors live on.

The port's entry points (the Trainer, the command line and the functions
that assemble device data: ``make_device_data``, ``make_eval_data``,
``params_from_numpy``) run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str) -> torch.device:
    """The run's device; a CUDA device that is not there is an error, never
    a quiet switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA device was requested but "
                               "torch.cuda.is_available() is False")
        # f32 matmuls must be true f32 (the reference requests HIGHEST)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them (a card set below
    its maximum power runs slower under load), for every number measured
    on it; the name alone where nvidia-smi cannot be run."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "--id=0"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(0)}, power limit not read"
