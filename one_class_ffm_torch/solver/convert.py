"""Block tables between numpy and the port's tensors.

The JAX package and the port keep the same parameter tree, ``{f12: {"W":
(D1, k), "H": (D2, k)}}``; these helpers move it across as numpy arrays, so
both solvers can start from one state.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def params_from_numpy(params_np: Dict[int, Dict[str, np.ndarray]],
                      device: torch.device | str = "cpu",
                      dtype: torch.dtype = torch.float32,
                      ) -> Dict[int, Dict[str, torch.Tensor]]:
    return {
        int(f12): {name: torch.as_tensor(np.asarray(t, np.float64))
                   .to(device=device, dtype=dtype)
                   for name, t in blk.items()}
        for f12, blk in params_np.items()
    }


def params_to_numpy(params: Dict[int, Dict[str, torch.Tensor]],
                    ) -> Dict[int, Dict[str, np.ndarray]]:
    """Host copies; bfloat16 tables come back as float32 (numpy has no
    bfloat16)."""
    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return {f12: {name: host(t) for name, t in blk.items()}
            for f12, blk in params.items()}
