"""B6 and B7 split into the kernels' two stages, against
``hv_self_tbl_plain`` and ``grad_self_tbl_plain``.

The CUDA B6 and B7 (csrc/table_ops.cu) write no payload rows: their row
stages write one scale per row, B6's s_i = storage(dd_i * storage(<Q1[i],
phib_i>)), B7's zb_i = storage(zdense_i + z_i) with z_i the row's run of
slot coefficients added in slot order from +0 (read from the static row
runs), and their X^T stage forms each gathered entry's payload row itself,
storage(scale[row] * Q1[row]), before the entry's product with its value;
B7's Jacobi payload, storage(storage(dd[row] * Q1[row]) * Q1[row]), is
formed the same way and gathered through X^2.  Here a torch model of that
split, written from the kernels' rules, runs on the CPU and must give the
plain versions' bits at float32 and bfloat16: each chunk of a feature's
entries summed in list order from +0, a single-chunk feature's sum written
as it is, a multi-chunk feature's chunk sums added in chunk order from
+0."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops.layout import (
    FeatureMajor,
    feature_major,
    row_runs,
)
from one_class_ffm_torch.ops.sparse_ops import (
    _lane_dot,
    grad_self_tbl_plain,
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


def row_zb(zdense, c_blk, own, bm: int):
    """B7's stage 1: zb (rows,) at storage dtype, each row's run of slot
    coefficients (from layout.row_runs) added in slot order from +0 at
    float32, then zdense added and the sum rounded once."""
    dt, f32 = zdense.dtype, np.float32
    runs = row_runs(own.numpy(), bm)
    c = c_blk.to(torch.float32).numpy()
    z = np.zeros(zdense.shape[0], f32)
    for b in range(runs.shape[0]):
        for r in range(bm):
            acc = f32(0.0)
            for t in range(runs[b, r], runs[b, r + 1]):
                acc = f32(acc + c[b, t])
            z[b * bm + r] = acc
    return (zdense.to(torch.float32) + torch.from_numpy(z)).to(dt)


def xt_scaled(Q1, s, xt: FeatureMajor, sq: bool = False):
    """Stage 2: (d, k) float32 X^T of the rows storage(s[row] * Q1[row]),
    each formed per gathered entry, in the X^T stage's order; with ``sq``
    (B7's Jacobi payload) X^2 of the rows storage(storage(s[row] * Q1[row])
    * Q1[row])."""
    dt, f32 = Q1.dtype, torch.float32
    d, k = xt.feat_ptr.numel() - 1, Q1.shape[1]
    vals = xt.val_sq if sq else xt.val
    out = torch.zeros((d, k), dtype=f32)
    cptr, fptr = xt.chunk_ptr.tolist(), xt.feat_ptr.tolist()
    for f in range(d):
        sums = []
        for c in range(fptr[f], fptr[f + 1]):
            acc = torch.zeros(k, dtype=f32)
            for e in range(cptr[c], cptr[c + 1]):
                r = int(xt.row[e])
                q = Q1[r].to(f32)
                pay = (s[r].to(f32) * q).to(dt).to(f32)
                if sq:
                    pay = (pay * q).to(dt).to(f32)
                acc = acc + vals[e].to(f32) * pay
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

    # B7 on the same field and list: zb from each row's run of slot
    # coefficients, then the same X^T stage with zb as the scale, and its
    # Jacobi payload formed per entry through X^2
    own, c_blk, bm = _self_stream(rng, num // 20, 20, 30, dt)
    zdense = rng.normal(size=num)
    zdense[::6] = -0.0
    xt2 = xt._replace(val_sq=xt.val * xt.val)
    gargs = (xt2, args[4], T(zdense), own, c_blk, bm)
    zb = row_zb(gargs[2], c_blk, own, bm)
    assert zb.dtype == dt and zb.shape == (num,)
    gt, dq = grad_self_tbl_plain(*gargs, dd=args[5])
    assert np.array_equal(_bits(xt_scaled(args[4], zb, xt2)), _bits(gt))
    assert np.array_equal(_bits(xt_scaled(args[4], args[5], xt2, sq=True)),
                          _bits(dq)), (k, dt)


def _self_stream(rng, nb: int, bm: int, long_run: int, dt):
    """Slot owners and coefficients of nb blocks of bm rows: runs of 0-3
    slots with empty rows, one run of ``long_run`` slots per block, the
    last block's last rows empty, a few pads; coefficients holding -0.0,
    and a run whose values cancel exactly."""
    counts = rng.choice([0, 0, 1, 2, 3], size=(nb, bm))
    counts[:, 1] = long_run
    counts[-1, -3:] = 0
    maxc = int(counts.sum(axis=1).max()) + 5
    own = np.full((nb, maxc), bm, np.int32)
    for b in range(nb):
        run = np.repeat(np.arange(bm), counts[b])
        own[b, :run.size] = run
    c = rng.normal(size=own.shape) * (own < bm)
    c[rng.random(c.shape) < 0.15] = -0.0
    c[0, :long_run] = 0.0
    c[0, 1:4] = [1.5, -1.5, -0.0] if long_run >= 4 else c[0, 1:4]
    return torch.as_tensor(own), torch.as_tensor(c).to(dt), bm


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [8, 32])
@pytest.mark.parametrize("long_run", [5, 44, 73])
def test_grad_self_split_gives_plain_bits(dt, k, long_run):
    """B7's split (zb per row from its run, read from the static row runs,
    then storage(zb * Q1[row]) per gathered entry; the Jacobi payload
    storage(storage(dd * Q1[row]) * Q1[row]) per entry through X^2) equals
    grad_self_tbl_plain's two outputs bit for bit on runs of the u side's
    and the v side's lengths (mean 44, longest 73 slots), empty rows, a run
    that cancels to zero, -0.0 in the coefficients, zdense and Q1, and dd =
    0 rows."""
    rng = np.random.default_rng(60 + k + long_run)
    nb, bm, d, p = 3, 16, 19, 2
    num = nb * bm
    own, c_blk, _ = _self_stream(rng, nb, bm, long_run, dt)
    idx = rng.integers(0, d - 2, size=(num, p)).astype(np.int32)
    val = rng.uniform(0.5, 1.5, size=(num, p))
    idx[:, 0] = 1  # a heavy feature: many chunks
    val[rng.random((num, p)) < 0.2] = 0.0
    idx[val == 0] = 0
    fm = feature_major(idx, val, d, chunk=8)
    xt = FeatureMajor(row=torch.as_tensor(fm.row),
                      val=torch.as_tensor(fm.val).to(dt),
                      chunk_ptr=torch.as_tensor(fm.chunk_ptr),
                      feat_ptr=torch.as_tensor(fm.feat_ptr), n_rows=num)
    xt = xt._replace(val_sq=xt.val * xt.val)
    Q1 = rng.normal(size=(num, k))
    Q1[rng.random(Q1.shape) < 0.2] = -0.0
    zdense = rng.normal(size=num)
    zdense[::5] = -0.0
    dd = rng.random(num) * 5
    dd[::7] = 0.0
    Q1, zdense, dd = (torch.as_tensor(a).to(dt) for a in (Q1, zdense, dd))
    zb = row_zb(zdense, c_blk, own, bm)
    gt, dq = grad_self_tbl_plain(xt, Q1, zdense, own, c_blk, bm, dd=dd)
    assert gt.dtype == torch.float32 and gt.shape == (d, k)
    assert np.array_equal(_bits(xt_scaled(Q1, zb, xt)), _bits(gt))
    assert np.array_equal(_bits(xt_scaled(Q1, dd, xt, sq=True)), _bits(dq))
    # the plain version without dd: the gradient alone, the same bits
    assert np.array_equal(_bits(grad_self_tbl_plain(
        xt, Q1, zdense, own, c_blk, bm)), _bits(gt))
