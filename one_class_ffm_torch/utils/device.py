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
