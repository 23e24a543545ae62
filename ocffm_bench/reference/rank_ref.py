"""Plain PyTorch reference of full-catalog ranking.

For a user i and an item j the ranking score is

    z_ij = b_j + sum_{cross blocks} <X_fi(i) W, X_fj(j) H>

(b_j the item self blocks' sum of <X_fi(j) W, X_fj(j) H>; the user self
terms are the same for every item of a row and leave the order alone).  A
user with no feature is cold and scores the popularity prior.  The served
top-k of a row is judged by the gap by which a served item's reference
score lies below the reference's score at the same rank, over the row's
largest absolute score; ids that are repeated or outside the catalog
fail outright.

Inputs are the benchmark's plain arrays and tables; nothing of the
program is read.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .ffm_ref import Field, blocks

Tensor = torch.Tensor


class RankReference:
    def __init__(self, problem, tables, self_side: bool, device,
                 dtype=torch.float64):
        self.device, self.dtype = torch.device(device), dtype
        users, items = problem.users, problem.items
        self.users = users
        self.blocks = blocks(len(users.dims), len(items.dims), self_side)
        self.cross = [b for b in self.blocks if b.kind == "uv"]
        Xv = [Field(i, v, s, d, device, dtype) for i, v, s, d in
              zip(items.idx, items.val, items.ident, items.dims)]
        self.tables = {f: {n: t.to(device, dtype) for n, t in blk.items()}
                       for f, blk in tables.items()}
        self.Q = {b.f12: Xv[b.fj].project(self.tables[b.f12]["H"])
                  for b in self.cross}
        bt = torch.zeros(items.rows, dtype=dtype, device=device)
        for b in self.blocks:
            if b.kind == "vv":
                bt = bt + (Xv[b.fi].project(self.tables[b.f12]["W"])
                           * Xv[b.fj].project(self.tables[b.f12]["H"])
                           ).sum(dim=1)
        self.bt = bt
        self.pop = torch.as_tensor(problem.popular, device=device).to(dtype)

    def scores(self, user_ids: np.ndarray) -> Tensor:
        """(len(user_ids), items) reference scores."""
        ids = np.asarray(user_ids)
        Xu = [Field(i[ids], v[ids], False, d, self.device, self.dtype)
              for i, v, d in zip(self.users.idx, self.users.val,
                                 self.users.dims)]
        z = self.bt[None, :].expand(len(ids), -1)
        for b in self.cross:
            P = Xu[b.fi].project(self.tables[b.f12]["W"])
            z = z + P @ self.Q[b.f12].T
        cold = torch.stack([x.val.abs().sum(dim=1) for x in Xu]).sum(0) == 0
        return torch.where(cold[:, None], self.pop[None, :], z)

    def judge(self, user_ids: np.ndarray, served: np.ndarray
              ) -> Dict[str, float]:
        """{"gap": the widest served-score gap over the batch, relative to
        each row's largest |score|; "bad_ids": rows with a repeated or
        out-of-range id}."""
        served = np.asarray(served)
        n_items = self.bt.shape[0]
        srt = np.sort(served, axis=1)
        bad = ((served < 0) | (served >= n_items)).any(axis=1) \
            | (srt[:, 1:] == srt[:, :-1]).any(axis=1)
        z = self.scores(user_ids)
        k = served.shape[1]
        best = torch.topk(z, k, dim=1).values
        sv = torch.as_tensor(np.clip(served, 0, n_items - 1),
                             device=self.device).long()
        got = torch.gather(z, 1, sv)
        scale = z.abs().amax(dim=1).clamp_min(torch.finfo(z.dtype).tiny)
        gap = ((best - got) / scale[:, None]).amax(dim=1)
        return dict(gap=float(gap.max()), bad_ids=int(bad.sum()))
