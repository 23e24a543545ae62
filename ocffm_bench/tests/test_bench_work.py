"""The required-work counts against hand-computed small shapes."""

import pytest

from ocffm_bench import work

PEAKS = {"f32_flops_per_s": 1.0, "bytes_per_s": 1.0}


def mf(m=10, n=20, nnz=30, k=2):
    f = work.FieldShape
    return work.Shape(m, n, nnz, k, (f(m, 1, True),), (f(n, 1, True),),
                      False)


def test_mf_epoch_by_hand():
    s = mf()
    c = work.Counter(PEAKS)
    work.epoch_work(s, [1, 2], c)
    k, F, nnz = 2, 4, 30
    # W half-solve: own rows 10, other 20; H half-solve: own 20, other 10
    want_flops = want_bytes = 0.0
    for d1, n1, n2, it in ((10, 10, 20, 1), (20, 20, 10, 2)):
        tbl = F * d1 * k
        want_flops += 2 * nnz * k + 2 * k * k * (n1 + n2)
        want_bytes += 2 * tbl + F * k * (n1 + n2) + F * (n1 + n2) \
            + 3 * F * nnz
        want_flops += 2 * d1 * k
        want_bytes += 4 * tbl
        want_flops += it * (4 * nnz * k + 2 * n1 * k * k + 10 * d1 * k)
        want_bytes += it * (2 * tbl + F * n2 * k + 2 * F * nnz + 7 * tbl)
        want_flops += d1 * k + 2 * nnz * k
        want_bytes += 3 * tbl + 2 * F * n1 * k + F * n2 * k + 4 * F * nnz
    assert c.flops == pytest.approx(want_flops)
    assert c.bytes == pytest.approx(want_bytes)


def test_least_time_takes_the_larger_bound():
    c = work.Counter({"f32_flops_per_s": 10.0, "bytes_per_s": 100.0})
    c.add(50.0, 100.0)  # 5 s of flops, 1 s of bytes
    c.add(10.0, 1000.0, times=2)  # 1 s and 10 s, twice
    assert c.seconds == pytest.approx(5.0 + 20.0)


def test_rank_request_by_hand():
    f = work.FieldShape
    s = work.Shape(100, 50, 0, 4, (f(100, 1, True), f(9, 3, False)),
                   (f(50, 1, True),), True)
    c = work.Counter(PEAKS)
    work.rank_request_work(s, users=8, top_k=2, c=c)
    k, n, U, F = 4, 50, 8, 4
    proj_f = 2 * U * 1 * k + 2 * U * 3 * k
    proj_b = F * U * 1 * k + F * U * 3 * k + 2 * F * U * 3
    assert c.flops == pytest.approx(proj_f + 2 * U * n * k * 2 + U * n * 3)
    assert c.bytes == pytest.approx(proj_b + F * n * k * 2 + F * n
                                    + 2 * F * U * 2)


def test_epoch_count_must_match_the_half_solves():
    with pytest.raises(ValueError):
        work.epoch_work(mf(), [1], work.Counter(PEAKS))


def test_half_solves_in_epoch_order():
    f = work.FieldShape
    s = work.Shape(10, 20, 5, 2, (f(10, 1, True), f(4, 2, False)),
                   (f(20, 1, True),), True)
    kinds = [h[0] for h in work.half_solves(s)]
    # uu (0,0), (0,1), (1,1); no vv pair but (0,0) on the items; then uv
    assert kinds == ["uu"] * 6 + ["vv"] * 2 + ["uv"] * 4


def test_peaks_table_names_the_card():
    p = work.load_peaks("NVIDIA H100 80GB HBM3")
    assert p["f32_flops_per_s"] == 67e12 and p["bytes_per_s"] == 3.35e12
