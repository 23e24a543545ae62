"""B6 split into the kernel's two stages, against ``hv_self_tbl_plain``.

The CUDA B6 (csrc/table_ops.cu) writes no payload rows: its row stage
writes one scale per row, s_i = storage(dd_i * storage(<Q1[i], phib_i>)),
and its X^T stage forms each gathered entry's payload row itself,
storage(s[row] * Q1[row]), before the entry's product with its value.  Here
a torch model of that split, written from the kernels' rules, runs on the
CPU and must give the plain version's bits at float32 and bfloat16: each
chunk of a feature's entries summed in list order from +0, a single-chunk
feature's sum written as it is, a multi-chunk feature's chunk sums added
in chunk order from +0."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops.layout import FeatureMajor, feature_major
from one_class_ffm_torch.ops.sparse_ops import (
    _lane_dot,
    hv_self_tbl_plain,
    project_plain,
)

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


def row_scale(V, x_idx, x_val, Q1, dd):
    """Stage 1: s (rows,) at storage dtype.  The dot's order is
    ``_lane_dot``'s, which tests/test_torch_hv_tree.py holds the kernel's
    group tree to."""
    dt, f32 = Q1.dtype, torch.float32
    phib = project_plain(x_idx, x_val, V)
    dot = _lane_dot(Q1.to(f32), phib.to(f32))
    return (dd.to(f32) * dot.to(dt).to(f32)).to(dt)


def xt_scaled(Q1, s, xt: FeatureMajor):
    """Stage 2: (d, k) float32 X^T of the rows storage(s[row] * Q1[row]),
    each formed per gathered entry, in the X^T stage's order."""
    dt, f32 = Q1.dtype, torch.float32
    d, k = xt.feat_ptr.numel() - 1, Q1.shape[1]
    out = torch.zeros((d, k), dtype=f32)
    cptr, fptr = xt.chunk_ptr.tolist(), xt.feat_ptr.tolist()
    for f in range(d):
        sums = []
        for c in range(fptr[f], fptr[f + 1]):
            acc = torch.zeros(k, dtype=f32)
            for e in range(cptr[c], cptr[c + 1]):
                r = int(xt.row[e])
                pay = (s[r].to(f32) * Q1[r].to(f32)).to(dt).to(f32)
                acc = acc + xt.val[e].to(f32) * pay
            sums.append(acc)
        if len(sums) == 1:  # written straight to the output
            out[f] = sums[0]
        else:
            for part in sums:  # featureless: the zero row
                out[f] = out[f] + part
    return out


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32, 40])
def test_two_stage_split_gives_plain_bits(dt, k):
    """The split equals hv_self_tbl_plain bit for bit, signs of zero
    included, on a field with pad rows, pad slots, ghost ids in X's rows
    (the projection drops them; the list never holds them), dd = 0 rows,
    -0.0 in V and Q1, and features with one chunk, several chunks (a
    chunk of 4 entries) and none."""
    rng = np.random.default_rng(17 + k)
    num, d, p = 60, 23, 3
    idx = rng.integers(0, d - 3, size=(num, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(num, p))
    idx[:, 0] = 2  # a heavy feature: many chunks
    val[rng.random((num, p)) < 0.2] = 0.0  # pad slots
    val[:, 0] = 1.0
    idx[val == 0] = 0
    idx[-4:], val[-4:] = 0, 0.0  # pad rows
    fm = feature_major(idx, val, d, chunk=4)
    nch = np.diff(fm.feat_ptr)
    assert nch[2] > 1 and (nch == 1).any() and (nch == 0).any()
    x_idx = idx.copy()
    x_idx[::7, 1] = d + 5  # ghost ids, in X's rows only
    x_idx[::9, 2] = -1
    V = rng.normal(size=(d, k))
    V[::4] = -0.0
    Q1 = rng.normal(size=(num, k))
    Q1[rng.random(Q1.shape) < 0.2] = -0.0
    Q1[:3] = -0.0
    dd = rng.random(num) * 5
    dd[::5] = 0.0

    def T(a):
        return torch.as_tensor(a).to(dt)

    xt = FeatureMajor(row=torch.as_tensor(fm.row),
                      val=torch.as_tensor(fm.val).to(dt),
                      chunk_ptr=torch.as_tensor(fm.chunk_ptr),
                      feat_ptr=torch.as_tensor(fm.feat_ptr), n_rows=num)
    args = (T(V), torch.as_tensor(x_idx), T(val), xt, T(Q1), T(dd))
    s = row_scale(*args[:3], args[4], args[5])
    assert s.dtype == dt and s.shape == (num,)
    assert torch.all(s[::5] == 0)
    got = xt_scaled(args[4], s, xt)
    ref = hv_self_tbl_plain(*args)
    assert ref.dtype == torch.float32 and ref.shape == (d, k)
    assert np.array_equal(_bits(got), _bits(ref)), (k, dt)
    assert torch.all(got[torch.as_tensor(nch == 0)] == 0)
