"""The kernels' group dot (csrc/common.cuh hv_slots and lane_tree; B6's
row stage, csrc/table_ops.cu SelfScale) against ``_lane_dot``, the order
the plain versions fix.

B1, B4's row stage and B6's row stage take a width plan (G lanes per row,
NV vectors of VE values per lane) and fold each dot with a butterfly whose
upper levels are shuffles inside the group and whose lower levels are adds
in a lane's registers.  Here a torch model of that reduction, written from the
kernel's rules, runs at float32 on the CPU and must give ``_lane_dot``'s
bits, the sign of zero included: lane g holds columns (v * G + g) * VE + i;
lane sums of columns l, l + 32, ... come first (plain-load plan); a level's
partner past the group, or at a column past k, adds +0."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops.sparse_ops import _lane_dot

torch.set_num_threads(1)

K_MAX_PER_LANE = 8  # common.cuh kMaxKPerLane


def plan(k: int, elem_bytes: int):
    """(G, NV, VE) as common.cuh by_width picks it for hv_rows and B6's row
    stage: the vector plan (16-byte vectors, the smallest power-of-two
    group covering k) for k <= 32 on aligned rows, else the plain-load
    plan."""
    ve = 16 // elem_bytes
    if k > 32 or (k * elem_bytes) % 16:
        return 32, K_MAX_PER_LANE, 1
    g = 1
    while g * ve < k:
        g *= 2
    return g, 1, ve


def tree_dot(a: torch.Tensor, b: torch.Tensor, G: int, NV: int, VE: int):
    """The kernel's dot of the rows of a and b (float32, (n, k)) on plan
    (G, NV, VE); returns (n, G, VE): every lane's every value, all of which
    the kernel leaves equal."""
    n, k = a.shape
    width = NV * G * VE
    # columns past k: phi and the row are 0, their products +0
    p = torch.nn.functional.pad(a * b, (0, width - k))
    p = p.reshape(n, NV, G, VE)
    x = p[:, 0].clone()
    for v in range(1, NV):  # lane sums l, l + 32, ... (G * VE == 32)
        if v * G * VE < k:
            x = x + p[:, v]
    lanes = torch.arange(G)
    off = 16
    while off:
        if off >= VE:
            lo = off // VE
            if lo >= G:  # no partner lane: +0, added, not skipped
                x = x + torch.zeros((), dtype=x.dtype)
            else:
                x = x + x[:, lanes ^ lo, :]
        else:
            ids = torch.arange(VE)
            x = x + x[:, :, ids ^ off]
        off //= 2
    return x


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


@pytest.mark.parametrize("k, elem_bytes, want", [
    (32, 4, (8, 1, 4)),    # f32 at k = 32: 8 lanes x one float4
    (32, 2, (4, 1, 8)),    # bf16 at k = 32: 4 lanes x 8 values
    (8, 4, (2, 1, 4)),     # levels 16 and 8 find no partner lane
    (24, 4, (8, 1, 4)),    # lanes 6 and 7 hold columns past k
    (4, 4, (1, 1, 4)),     # one lane: every level above VE adds +0
    (64, 4, (32, 8, 1)),   # k > 32: the plain-load plan, two lane sums
    (40, 2, (32, 8, 1)),
    (12, 2, (32, 8, 1)),   # 24-byte rows: no 16-byte vectors
])
def test_group_tree_gives_lane_dot_bits(k, elem_bytes, want):
    """Random rows, rows with -0.0 in phi and exact zeros in the stream,
    and rows whose every product is -0: the model's dot has _lane_dot's
    bits and every lane ends with the same bits."""
    G, NV, VE = plan(k, elem_bytes)
    assert (G, NV, VE) == want
    rng = np.random.default_rng(k * 10 + elem_bytes)
    n = 64
    a = rng.normal(size=(n, k)).astype(np.float32)
    b = rng.normal(size=(n, k)).astype(np.float32)
    a[rng.random((n, k)) < 0.2] = -0.0
    b[rng.random((n, k)) < 0.2] = 0.0
    a[:8], b[:8] = -0.0, np.abs(b[:8])  # every product -0
    a[8:16] = np.abs(a[8:16])
    a[8:16, ::2], b[8:16, 1::2] = -0.0, 0.0
    a[16:20] *= 1e30  # large products beside small ones
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    got = tree_dot(a, b, G, NV, VE)
    ref = _lane_dot(a, b)
    flat = got.reshape(n, -1)
    assert np.array_equal(_bits(flat), np.repeat(_bits(flat[:, :1]),
                                                 flat.shape[1], axis=1))
    assert np.array_equal(_bits(flat[:, 0]), _bits(ref)), (k, elem_bytes)
    # the all -0 rows: -0 where k fills the 32 lanes, +0 where padding does
    zero_sign = torch.signbit(ref[:8])
    assert bool(torch.all(zero_sign)) == (k % 32 == 0 and k >= 32)


def _storage(x: torch.Tensor, dt) -> torch.Tensor:
    """float32 values rounded to storage dtype and widened back (a kernel's
    rounding points)."""
    return x.to(dt).to(torch.float32)


def self_scale(q, ph, dd, dt, G, NV, VE):
    """B6's row stage on plan (G, NV, VE), from the kernel's rules: the
    group dot of Q1[i] and phib_i (q, ph: float32 holding storage values),
    rounded to storage, times dd_i, rounded to storage:
    s_i = storage(dd_i * storage(<Q1[i], phib_i>))."""
    dot = tree_dot(q, ph, G, NV, VE)[:, 0, 0]
    return _storage(dd * _storage(dot, dt), dt)


@pytest.mark.parametrize("k", [8, 32, 40, 64])
@pytest.mark.parametrize("elem_bytes, dt", [(4, torch.float32),
                                            (2, torch.bfloat16)])
def test_self_scale_gives_lane_dot_bits(k, elem_bytes, dt):
    """B6's dot on its plans (k <= 32: 16-byte vectors, two or eight lanes
    short of a warp at k = 8; k = 40 and 64: the plain-load plan, two lane
    sums) with zeros of both signs in Q1 and phib gives ``_lane_dot``'s
    bits, and its s has hv_self_tbl_plain's roundings: the dot and the
    product with dd each rounded to storage."""
    G, NV, VE = plan(k, elem_bytes)
    assert G * NV * VE >= k and (NV == 1 or G * VE == 32)
    rng = np.random.default_rng(k * 10 + elem_bytes + 1)
    n = 96
    q = rng.normal(size=(n, k)).astype(np.float32)
    ph = rng.normal(size=(n, k)).astype(np.float32)
    q[rng.random((n, k)) < 0.2] = -0.0
    ph[rng.random((n, k)) < 0.2] = 0.0
    q[:8], ph[:8] = -0.0, np.abs(ph[:8])  # every product -0
    q[8:16], ph[8:16] = 0.0, -np.abs(ph[8:16])  # every product -0 too
    ph[16:24] = -0.0  # zeros of both signs meet
    q[24:32] = 0.0
    dd = rng.random(n).astype(np.float32) * 5
    dd[::7] = 0.0
    q, ph = _storage(torch.from_numpy(q), dt), _storage(torch.from_numpy(ph),
                                                        dt)
    dd = _storage(torch.from_numpy(dd), dt)
    got = tree_dot(q, ph, G, NV, VE)
    ref = _lane_dot(q, ph)
    flat = got.reshape(n, -1)
    assert np.array_equal(_bits(flat), np.repeat(_bits(flat[:, :1]),
                                                 flat.shape[1], axis=1))
    assert np.array_equal(_bits(flat[:, 0]), _bits(ref)), (k, dt)
    # hv_self_tbl_plain's s: (dd * dot.to(dt).to(f32)).to(dt)
    s = self_scale(q, ph, dd, dt, G, NV, VE)
    want = (dd * ref.to(dt).to(torch.float32)).to(dt).to(torch.float32)
    assert np.array_equal(_bits(s), _bits(want)), (k, dt)
    assert torch.all(s[::7] == 0)
    if dt == torch.bfloat16:  # both roundings change some rows' bits
        no_inner = _storage(dd * ref, dt)
        assert not np.array_equal(_bits(s), _bits(no_inner))
        assert not np.array_equal(_bits(s), _bits(dd * ref))
