"""Each row's top K (``sparse_ops.topk_rows``, predict's ``rank_topk``).

On the CPU: the dispatcher's plain route is the stable descending sort,
``rank_topk`` still gives the sort's first K (float32, bfloat16, float64,
rows and column slices), a model of the kernel's key orders rows as that
sort does (float32 and bfloat16 widened), and the kernel's wrapper raises
on what the kernel does not take.  Marked ``cuda`` (skipped without a
card): the top-K kernel (csrc/topk_ops.cu) against ``torch.sort(z, dim=1,
descending=True, stable=True)``'s first K, ids and value bits, float32 and
bfloat16, on random rows at the rank cell's shape, rows of ties, an
ascending row, -0.0 / +0.0 and NaN / +-inf (the order of the card's sort
pinned first), a column slice, the merge rows of the item-sharded top-K, K
from 1 to 256 and K = the row length, and repeated calls; the dispatcher
raises on the card for another dtype or K past 256.  On the GPU machine:

    python -m pytest tests/test_torch_topk.py -m cuda --noconftest -q

This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as ops
from one_class_ffm_torch.predict import rank_topk

torch.set_num_threads(1)


def _sorted(z, k):
    srt = torch.sort(z, dim=1, descending=True, stable=True)
    return srt.values[:, :k], srt.indices[:, :k]


def _bits(t):
    """A float tensor's bit patterns (torch.equal holds -0.0 equal to
    +0.0 and NaN unequal to itself)."""
    return t.contiguous().view(torch.int16)


def _rows(kind, rows, n, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    if kind == "random":
        z = rng.normal(size=(rows, n))
    elif kind == "integers":
        z = rng.integers(0, 4, size=(rows, n))
    elif kind == "equal":
        z = np.full((rows, n), 2.5)
    elif kind == "ascending":
        z = np.tile(np.arange(n), (rows, 1))
    else:  # a popularity prior: a few popular items, the rest 0
        z = np.zeros((rows, n))
        head = max(1, n // 20)
        z[:, :head] = np.round(np.sort(rng.random(head))[::-1], 1)
    return torch.from_numpy(np.ascontiguousarray(z, dtype=np.float32)).to(
        dtype)


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

KINDS = ["random", "integers", "equal", "ascending", "popularity"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n,k", [(1, 1), (7, 3), (64, 10), (300, 80),
                                 (300, 300), (20, 30)])
def test_plain_route_is_the_stable_sort(kind, n, k):
    z = _rows(kind, 5, n, seed=n + k)
    vals, ids = ops.topk_rows(z, k)
    want_v, want_i = _sorted(z, k)
    assert ids.dtype == torch.int64 and ids.shape == (5, min(k, n))
    assert torch.equal(ids, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))


def test_dispatcher_raises_on_another_device():
    with pytest.raises(ValueError, match="no kernel"):
        ops.topk_rows(torch.zeros(4, 8, device="meta"), 3)


def _key_model(z):
    """The kernel's keys of the rows of ``z`` (uint64, numpy): a bfloat16
    widened to float32, -0.0 folded onto +0.0, the radix sort's order of
    the bits, then the column inverted below them."""
    u = z.float().numpy().view(np.uint32).copy()
    u[u == 0x80000000] = 0
    o = np.where(u >> 31 == 1, ~u, u | np.uint32(0x80000000))
    col = np.arange(z.shape[1], dtype=np.uint64)
    return (o.astype(np.uint64) << np.uint64(32)) | (
        np.uint64(0xFFFFFFFF) - col)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", KINDS)
def test_key_model_orders_as_the_stable_sort(kind, dtype):
    """The kernel's key, modelled in numpy, ranks rows (with -0.0 and +0.0
    among their values) as the stable descending sort does, whole rows."""
    z = _rows(kind, 6, 400, seed=5, dtype=dtype)
    rng = np.random.default_rng(7)
    for r in range(6):
        z[r, rng.choice(400, size=8, replace=False)] = -0.0
        z[r, rng.choice(400, size=8, replace=False)] = 0.0
    keys = _key_model(z)
    assert all(len(np.unique(row)) == row.size for row in keys)
    got = np.argsort(keys, axis=1, kind="stable")[:, ::-1]
    assert np.array_equal(got, _sorted(z, 400)[1].numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_rank_topk_is_the_stable_sort(kind, dtype):
    """Also on a column slice of a wider matrix (predict's --catalog)."""
    z = _rows(kind, 6, 500, seed=3, dtype=dtype)
    for view in (z, z[:, :333]):
        vals, ids = rank_topk(view, 10)
        want_v, want_i = _sorted(view, 10)
        assert torch.equal(ids, want_i)
        assert torch.equal(_bits(vals), _bits(want_v))


@pytest.mark.parametrize("z,k,err,match", [
    (torch.zeros(4, 8, dtype=torch.float64), 3, TypeError, "float32"),
    (torch.zeros(4, 8, dtype=torch.float16), 3, TypeError, "bfloat16"),
    (torch.zeros(2, 4, 8), 3, ValueError, "rows, n"),
    (torch.zeros(8), 3, ValueError, "rows, n"),
    (torch.zeros(4, 8), 0, ValueError, "range"),
    (torch.zeros(4, 300), 257, ValueError, "range"),
    (torch.zeros(8, 4).T, 3, ValueError, "unit-stride"),
    (torch.zeros(4, 8)[:, ::2], 3, ValueError, "unit-stride"),
    (torch.zeros(4, 8), 3, ValueError, "CUDA"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(z, k, err, match):
    with pytest.raises(err, match=match):
        kernels.topk_rows(z, k)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the GPU machine)")
    return torch.device("cuda", 0)


def _check(z, k):
    """The kernel's (values, ids) bit-equal to the stable sort's first k,
    twice, each call one launch; returns them."""
    before = kernels.launch_counts()["topk_rows"]
    vals, ids = ops.topk_rows(z, k)
    vals2, ids2 = ops.topk_rows(z, k)
    assert kernels.launch_counts()["topk_rows"] == before + 2
    want_v, want_i = _sorted(z, k)
    assert vals.dtype == z.dtype
    assert torch.equal(ids, want_i)
    assert torch.equal(_bits(vals), _bits(want_v))
    assert torch.equal(ids2, ids) and torch.equal(_bits(vals2), _bits(vals))
    return vals, ids


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 5, 10, 80, 256])
def test_kernel_at_the_rank_cells_shape(device, k, dtype):
    g = torch.Generator(device=device).manual_seed(k)
    _check(torch.randn((1024, 359_966), generator=g, device=device).to(dtype),
           k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("k", [1, 10, 80, 256])
def test_kernel_on_rows_of_ties_and_orders(device, kind, k, dtype):
    """Integer values, all-equal rows, a popularity prior like the cold
    users' (mostly 0) and ascending rows (every element beats the
    threshold; at bfloat16 runs of equal values)."""
    _check(_rows(kind, 64, 100_003, seed=k, dtype=dtype).to(device), k)


# -0.0, +0.0, a NaN, a NaN with the sign bit, a signalling NaN's bits, +inf,
# -inf, then again -0.0, +0.0 and the first NaN: float32 bits, and the same
# values' bfloat16 bits (the upper half; the signalling NaN keeps a payload
# bit there)
SPECIAL_BITS = {
    torch.float32: [0x80000000, 0x00000000, 0x7FC00000, 0xFFC00000,
                    0x7F800001, 0x7F800000, 0xFF800000, 0x80000000,
                    0x00000000, 0x7FC00000],
    torch.bfloat16: [0x8000, 0x0000, 0x7FC0, 0xFFC0, 0x7F81, 0x7F80, 0xFF80,
                     0x8000, 0x0000, 0x7FC0],
}


def _special(dtype):
    bits = SPECIAL_BITS[dtype]
    if dtype == torch.float32:
        return torch.from_numpy(np.array(bits, dtype=np.uint32).view(
            np.float32))
    return torch.from_numpy(np.array(bits, dtype=np.uint16).view(
        np.int16)).view(torch.bfloat16)


def _with_specials(rows, n, seed, dtype):
    """Rows of values below -1 with the specials at random columns, in
    their order; returns them and the columns."""
    rng = np.random.default_rng(seed)
    z = torch.from_numpy(
        (-np.abs(rng.normal(size=(rows, n))) - 1.0).astype(np.float32)).to(
        dtype)
    special = _special(dtype)
    cols = []
    for r in range(rows):
        at = np.sort(rng.choice(n, size=len(special), replace=False))
        z[r, torch.from_numpy(at)] = special
        cols.append(at)
    return z, cols


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [10, 64, 129, 4097, 359_966])
def test_the_cards_sort_orders_zeros_and_nans(device, n, dtype):
    """Pins what the card's stable descending sort does, which the kernel's
    key follows: -0.0 and +0.0 rank equal (so by column), NaNs rank by
    their bits (without the sign bit above +inf, the larger bits first;
    with it below -inf)."""
    z, (at,) = _with_specials(1, n, n, dtype)
    got = torch.sort(z[0].to(device), descending=True,
                     stable=True).indices.cpu().numpy()
    want = list(at[[2, 9, 4, 5, 0, 1, 7, 8]])  # NaNs, +inf, the zeros
    assert got[:8].tolist() == want
    assert got[-2:].tolist() == [at[6], at[3]]  # -inf, then the -NaN


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [10, 64, 129, 4097, 359_966])
@pytest.mark.parametrize("k", [5, 10, 80])
def test_kernel_on_zeros_nans_and_infinities(device, n, k, dtype):
    z, _ = _with_specials(32, n, n + k, dtype)
    _check(z.to(device), min(k, n))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [10, 80])
def test_kernel_on_a_column_slice(device, k, dtype):
    """``z[:, :cat]`` with cat < n, as predict passes with --catalog: the
    kernel reads the view in place (rows at a stride, starting on every
    alignment)."""
    g = torch.Generator(device=device).manual_seed(k)
    z = torch.randn((256, 100_001), generator=g, device=device).to(dtype)
    for view in (z[:, :77_777], z[:, 3:50_002], z[5:, 1:], z[:, 7:90_000]):
        _check(view, k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("ranks,k", [(2, 10), (4, 10), (4, 80), (2, 256)])
def test_kernel_on_sharded_merge_rows(device, ranks, k, dtype):
    """The merge of ``sharded_topk``: (users, ranks * k) candidates, each
    rank's run sorted, with ties across ranks."""
    g = torch.Generator(device=device).manual_seed(ranks * k)
    runs = torch.randint(0, 5, (1024, ranks, k), generator=g, device=device)
    cand = torch.sort(runs.to(dtype), dim=2, descending=True).values
    _check(cand.reshape(1024, ranks * k), k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 5, 16, 80, 256])
def test_kernel_with_k_the_row_length(device, n, dtype):
    g = torch.Generator(device=device).manual_seed(n)
    z = torch.randint(0, 3, (300, n), generator=g, device=device).to(dtype)
    _check(z, n)
    if n < kernels.TOPK_MAX_K:  # k past the row: the whole row
        vals, ids = ops.topk_rows(z, min(n + 7, kernels.TOPK_MAX_K))
        assert ids.shape == (300, n)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_repeats_its_output(device, dtype):
    g = torch.Generator(device=device).manual_seed(0)
    z = torch.randint(0, 50, (1024, 200_000), generator=g,
                      device=device).to(dtype)
    vals, ids = ops.topk_rows(z, 10)
    for _ in range(5):
        v, i = ops.topk_rows(z, 10)
        assert torch.equal(i, ids) and torch.equal(_bits(v), _bits(vals))


@pytest.mark.cuda
def test_dispatcher_raises_on_the_card_for_what_the_kernel_does_not_take(
        device):
    z = _rows("integers", 8, 1000).to(device)
    before = kernels.launch_counts()["topk_rows"]
    for zz, k, err in ((z.double(), 10, TypeError), (z.half(), 10, TypeError),
                       (z, 300, ValueError), (z, 0, ValueError)):
        with pytest.raises(err):
            ops.topk_rows(zz, k)
    assert kernels.launch_counts()["topk_rows"] == before
