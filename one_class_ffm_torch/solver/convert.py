"""Block tables between numpy and the port's tensors.

The JAX package and the port keep the same parameter tree, ``{f12: {"W":
(D1, k), "H": (D2, k)}}``; these helpers move it across as numpy arrays, so
both solvers can start from one state.  A solver with ``d_multiple`` > 1
holds its tables at padded row dims (zero pad rows): ``pad_d`` pads them on
the way in, ``dims`` strips them to the true dims on the way out.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..utils.device import resolve_device


def pad_table(t, pad_d: Optional[Callable[[int], int]]) -> np.ndarray:
    """A table's rows padded with zero rows to ``pad_d(rows)`` (a
    ``ProblemMeta.pad_d``; None: as it is)."""
    t = np.asarray(t)
    dp = t.shape[0] if pad_d is None else pad_d(t.shape[0])
    if dp == t.shape[0]:
        return t
    return np.pad(t, [(0, dp - t.shape[0]), (0, 0)])


def params_from_numpy(params_np: Dict[int, Dict[str, np.ndarray]],
                      device: torch.device | str = "cuda",
                      dtype: torch.dtype = torch.float32,
                      pad_d: Optional[Callable[[int], int]] = None,
                      ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The tables on ``device`` (the card unless the caller asks for the
    CPU) at ``dtype``, each padded to ``pad_d(rows)`` rows when given."""
    device = resolve_device(device)
    return {
        int(f12): {name: torch.as_tensor(
            np.asarray(pad_table(t, pad_d), np.float64))
            .to(device=device, dtype=dtype)
            for name, t in blk.items()}
        for f12, blk in params_np.items()
    }


def params_to_numpy(params: Dict[int, Dict[str, torch.Tensor]],
                    dims: Optional[Dict[int, Dict[str, int]]] = None,
                    ) -> Dict[int, Dict[str, np.ndarray]]:
    """Host copies; bfloat16 tables come back as float32 (numpy has no
    bfloat16).  ``dims`` ({f12: {"W": D1, "H": D2}}): each table cut to its
    true rows (the pads of ``d_multiple`` stripped)."""
    def host(t: torch.Tensor) -> np.ndarray:
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return {f12: {name: host(t)[: None if dims is None else dims[f12][name]]
                  for name, t in blk.items()}
            for f12, blk in params.items()}
