"""Field-pair block bookkeeping.

A copy of ``one_class_ffm_tpu/models/blocks.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal.

The model has ``f = fu + fv`` fields (user fields first).  Every unordered
field pair (f1, f2), f1 <= f2, owns a latent block: two tables
``W[f12] (D_f1 x k)`` and ``H[f12] (D_f2 x k)``.  Blocks fall in three kinds:

  * ``uu``  — both fields on the user side (user self block)
  * ``vv``  — both on the item side (item self block)
  * ``uv``  — cross block (user field x item field)

Under ``self_side=False`` (the reference's ``--ns`` flag, train.cpp:147-150,
block skip ffm.cpp:502-503) only ``uv`` blocks exist.

``index_vec`` reproduces the reference's flat block id (ffm.cpp:53-55) so the
saved-model format lines up.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple


def index_vec(f1: int, f2: int, f: int) -> int:
    """Flat id of block (f1, f2), f1 <= f2, in the f(f+1)/2 block list."""
    return f2 + (f - 1) * f1 - f1 * (f1 - 1) // 2


@dataclass(frozen=True)
class BlockInfo:
    f12: int  # flat block id
    f1: int  # global field ids (user fields are 0..fu-1)
    f2: int
    kind: str  # 'uu' | 'vv' | 'uv'
    fi: int  # f1 as a local field index on its side
    fj: int  # f2 as a local field index on its side
    d1: int  # D_{f1}
    d2: int  # D_{f2}


@dataclass(frozen=True)
class BlockLayout:
    fu: int
    fv: int
    self_side: bool
    Du: Tuple[int, ...]  # per-user-field dims
    Dv: Tuple[int, ...]  # per-item-field dims

    @property
    def f(self) -> int:
        return self.fu + self.fv

    @staticmethod
    def make(Du: Sequence[int], Dv: Sequence[int], self_side: bool) -> "BlockLayout":
        return BlockLayout(
            fu=len(Du), fv=len(Dv), self_side=self_side, Du=tuple(Du), Dv=tuple(Dv)
        )

    def _info(self, f1: int, f2: int) -> BlockInfo:
        f = self.f
        if f2 < self.fu:
            kind = "uu"
        elif f1 >= self.fu:
            kind = "vv"
        else:
            kind = "uv"
        fi = f1 if f1 < self.fu else f1 - self.fu
        fj = f2 if f2 < self.fu else f2 - self.fu
        d1 = self.Du[fi] if f1 < self.fu else self.Dv[fi]
        d2 = self.Du[fj] if f2 < self.fu else self.Dv[fj]
        return BlockInfo(index_vec(f1, f2, f), f1, f2, kind, fi, fj, d1, d2)

    def all_blocks(self) -> List[BlockInfo]:
        """Active blocks in reference storage order (ffm.cpp:495-506)."""
        out = []
        for f1 in range(self.f):
            for f2 in range(f1, self.f):
                b = self._info(f1, f2)
                if not self.self_side and b.kind != "uv":
                    continue
                out.append(b)
        return out

    def user_self_blocks(self) -> List[BlockInfo]:
        if not self.self_side:
            return []
        return [
            self._info(f1, f2)
            for f1 in range(self.fu)
            for f2 in range(f1, self.fu)
        ]

    def item_self_blocks(self) -> List[BlockInfo]:
        if not self.self_side:
            return []
        return [
            self._info(f1, f2)
            for f1 in range(self.fu, self.f)
            for f2 in range(f1, self.f)
        ]

    def cross_blocks(self) -> List[BlockInfo]:
        return [
            self._info(f1, f2)
            for f1 in range(self.fu)
            for f2 in range(self.fu, self.f)
        ]

    def epoch_order(self) -> List[BlockInfo]:
        """Blocks in the order one epoch visits them (ffm.cpp:852-870):
        user self blocks, item self blocks, then cross blocks."""
        return self.user_self_blocks() + self.item_self_blocks() + self.cross_blocks()
