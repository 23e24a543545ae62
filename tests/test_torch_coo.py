"""The plain COO positive passes of the port: a side without a blocked
layout (``blocked_bm=0``, or a side the blocked builder rejects).

The COO ops (``pos_scatter``, ``pos_scatter_pair`` and its squared-only
form ``pos_scatter_sq``, ``pos_seg_sum``, the fused Hv ``pos_hv_coo``) and
the stream's ``pos_dot`` against the JAX package's (its XLA
``pos_scatter`` / ``pos_scatter_pair``, plain and chunked, ``segment_sum``,
``pos_dot`` and the two-call Hv), the destination-major list of the
stream (``layout.coo_list``), and the solver with both sides COO, with one
side of each (``mixed``: a popularity-skewed v side under
``head_chunk=0``), and with the head tier on the blocked side
(``mixed_head``: a power user on the u side, v rows not a multiple of the
block) against the fp64 oracle and the JAX solver, over MF, FFM (an
identity and a small feature field per side) and FM (one wide field per
side under a lowered fused-table cap), plain and Jacobi CG (passed
explicitly).  Float64 unless a test says otherwise."""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import make_problem, oracle_params_to_jax
from one_class_ffm_tpu.ops import sparse_ops as jops
from one_class_ffm_tpu.solver import jax_solver, oracle
from one_class_ffm_torch.ops import kernels
from one_class_ffm_torch.ops import sparse_ops as tops
from one_class_ffm_torch.ops.layout import (XT_CHUNK, coo_list,
                                            seg_sum_lanes, xt_plan)
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import params_from_numpy
from test_torch_imports import ROOT
from test_torch_solver import BM, _identity_field, padded
from test_torch_two_tier import J as _J
from test_torch_two_tier import T, _max_rel

torch.set_num_threads(1)

CHUNK = 8  # head chunk width of the mixed_head cases
CAP = 8  # the lowered fused-table cap of the FM cases
# against the JAX ops: f32 sums in another order; bf16: the port rounds
# each term and the sum once to storage, the JAX ops run at float32 on the
# same bf16 values (at bf16 they also round after every add: on the power
# rows' 15 and 30 entry sums that alone strays past 2^-7 of the largest
# output, 0.0084 on the sorted side's)
RTOL = {torch.float64: 1e-12, torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


# ---------------------------------------------------------------------------
# the COO ops against the JAX package's
# ---------------------------------------------------------------------------


def _stream(sort: bool, seed: int = 5):
    """A positive stream of 64 user rows x 40 item rows: a power item
    (row 3 of the v side, 30 entries: several chunks at the list's chunk of
    8) and a power user, ten pad entries (weight 0, ghost ids 64 / 40),
    sorted by u or shuffled."""
    rng = np.random.default_rng(seed)
    m, n = 64, 40
    u = rng.integers(0, m, size=150)
    v = rng.integers(0, n, size=150)
    v[:30] = 3
    u[30:45] = 7
    if sort:
        o = np.lexsort((v, u))
        u, v = u[o], v[o]
    else:
        o = rng.permutation(u.size)
        u, v = u[o], v[o]
    u = np.concatenate([u, np.full(10, m)]).astype(np.int32)
    v = np.concatenate([v, np.full(10, n)]).astype(np.int32)
    w = np.concatenate([np.ones(150), np.zeros(10)])
    return u, v, w, m, n


def _torch_list(lst, w=None):
    """A list of the stream as torch tensors; ``w`` (stream order, torch)
    its weights, carried in list order as ``val``."""
    out = lst._replace(**{f: T(getattr(lst, f)) for f in (
        "row", "chunk_ptr", "feat_ptr", "combine", "chunk_dst", "slot_feat",
        "pos")})
    return out if w is None else out._replace(val=w[out.pos.long()])


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("side", ["u", "v"], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("dt", list(RTOL), ids=str)
def test_coo_ops_match_jax(dt, side, chunked):
    """``pos_scatter``, ``pos_scatter_pair`` (its weights the list's, at a
    scale of 1) and ``pos_seg_sum`` through the list equal the JAX ops on
    the stream (pads and ghost ids in it; the u side's segments sorted, the
    v side's not; ``chunked``: the JAX ops' chunked form, max_chunk 7, and
    the list's chunks of 8 entries).  At bfloat16 the JAX ops take the same
    values at float32 (``RTOL``)."""
    u, v, w, m, n = _stream(sort=side == "u")
    seg, take, num, rows = (u, v, m, n) if side == "u" else (v, u, n, m)
    rng = np.random.default_rng(6)
    k = 4
    B = T(rng.normal(size=(rows, k)), dt)
    c = T(rng.normal(size=w.size) * w, dt)
    wq = T(rng.uniform(0.5, 1.5, size=w.size) * w, dt)
    lst = _torch_list(coo_list(seg, take, w != 0, num, rows,
                               chunk=8 if chunked else XT_CHUNK), wq)
    mc = 7 if chunked else 0
    sorted_ = side == "u"

    def J(t):  # noqa: N802 - the JAX twin of a torch tensor
        return _J(t.float() if t.dtype == torch.bfloat16 else t)

    zpos, posq = tops.pos_scatter_pair(c, B, lst, 1.0)
    rz, rq = jops.pos_scatter_pair(J(c), J(wq), J(B), J(T(take)),
                                   J(T(seg)), num, max_chunk=mc,
                                   seg_sorted=sorted_)
    out = {
        "pos_scatter": (tops.pos_scatter(c, B, lst),
                        jops.pos_scatter(J(c), J(B), J(T(take)), J(T(seg)),
                                         num, max_chunk=mc,
                                         seg_sorted=sorted_)),
        "pos_scatter_pair": (zpos, rz),
        "pos_scatter_pair diag": (posq, rq),
        "pos_seg_sum": (tops.pos_seg_sum(c, lst),
                        jax.ops.segment_sum(J(c), J(T(seg)),
                                            num_segments=num,
                                            indices_are_sorted=sorted_)),
    }
    assert torch.equal(zpos, out["pos_scatter"][0])
    assert torch.equal(posq, tops.pos_scatter_sq(B, lst, 1.0))
    for name, (got, ref) in out.items():
        assert got.dtype == dt, name
        assert tuple(got.shape) == tuple(ref.shape), name
        assert _max_rel(got, ref) <= RTOL[dt], name


def test_coo_ops_order_and_roundings():
    """The plain versions at bfloat16 are the kernel's function: each
    entry's term rounded to storage (c B, then (wq B) B with wq =
    storage(w storage(scale))), summed at float32 in the list's order (a
    chunk's entries, then a row's chunk sums), one rounding at the end; the
    width-1 sums of this list of short chunks add a chunk's entries in turn
    on one lane (``layout.seg_sum_lanes``), and on 8 lanes add entry i in
    lane i % 8 in turn, then fold the 8 lanes by an xor butterfly (4, 2,
    1); pad rows and rows without entries give +0."""
    u, v, w, m, n = _stream(sort=False)
    rng = np.random.default_rng(8)
    B = T(rng.normal(size=(m, 4)), torch.bfloat16)
    c = T(rng.normal(size=w.size) * w, torch.bfloat16)
    wts = T(rng.uniform(0.5, 1.5, size=w.size) * w, torch.bfloat16)
    lst = coo_list(v, u, w != 0, n + 4, m, chunk=8)  # 4 pad rows
    scale = 0.9
    got = tops.pos_scatter_plain(c, B, _torch_list(lst))
    gotq = tops.pos_scatter_pair_plain(c, B, _torch_list(lst, wts),
                                       scale)[1]
    gots = tops.pos_seg_sum_plain(c, _torch_list(lst))
    gots8 = tops.pos_seg_sum_plain(c, _torch_list(lst), lanes=8)
    assert seg_sum_lanes(lst.chunk_ptr) == 1
    Bf, cf = B.float(), c.float()
    s_bf = float(torch.tensor(scale, dtype=torch.bfloat16))
    for r in range(n + 4):
        ents = range(lst.feat_ptr[r], lst.feat_ptr[r + 1])
        acc = torch.zeros(4)
        accq = torch.zeros(4)
        accs = torch.zeros(())
        accs8 = torch.zeros(())
        for ch in ents:
            part = torch.zeros(4)
            partq = torch.zeros(4)
            lanes = [torch.zeros(()) for _ in range(8)]
            parts = torch.zeros(())
            for i, e in enumerate(range(lst.chunk_ptr[ch],
                                        lst.chunk_ptr[ch + 1])):
                b = Bf[lst.row[e]]
                t = (cf[lst.pos[e]] * b).bfloat16().float()
                part = part + t
                wq = (wts[lst.pos[e]].float() * s_bf).bfloat16().float()
                tq = (wq * b).bfloat16().float()
                partq = partq + (tq * b).bfloat16().float()
                parts = parts + cf[lst.pos[e]]
                lanes[i % 8] = lanes[i % 8] + cf[lst.pos[e]]
            for off in (4, 2, 1):
                lanes = [lanes[i] + lanes[i ^ off] for i in range(8)]
            acc, accq = acc + part, accq + partq
            accs, accs8 = accs + parts, accs8 + lanes[0]
        assert torch.equal(got[r], acc.bfloat16()), r
        assert torch.equal(gotq[r], accq.bfloat16()), r
        assert torch.equal(gots[r], accs.bfloat16()), r
        assert torch.equal(gots8[r], accs8.bfloat16()), r
    empty = np.setdiff1d(np.arange(n + 4), v[w != 0])
    assert empty.size and not got[empty].any()
    assert not torch.signbit(got[empty].float()).any()



@pytest.mark.parametrize("lengths, lanes", [
    ([4, 5, 3, 6], 1),  # users' chunks
    ([44, 40, 51], 1),  # a uniform catalog's items
    ([128] * 6 + [3] * 40, 8),  # a power item beside short ones
    ([], 1),
], ids=["short", "uniform", "power", "empty"])
def test_seg_sum_lanes_follow_chunk_lengths(lengths, lanes):
    """The width-1 sums take 8 lanes a chunk only where the mean length of
    an entry's chunk, sum(len^2) / sum(len), reaches ``SEG_SUM_WIDE``; the
    plain version adds in that order by default."""
    cp = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    assert seg_sum_lanes(cp) == lanes
    nnz = int(cp[-1])
    seg = np.repeat(np.arange(len(lengths)), lengths)
    lst = _torch_list(coo_list(seg, np.zeros(nnz, np.int64),
                               np.ones(nnz, bool), max(len(lengths), 1), 1))
    c = T(np.random.default_rng(3).normal(size=nnz), torch.float32)
    assert torch.equal(tops.pos_seg_sum_plain(c, lst),
                       tops.pos_seg_sum_plain(c, lst, lanes=lanes))


OMEGA = 0.1
# the fused Hv against the two-call form the port ran before it (pos_dot's
# sum in torch's order, not _lane_dot's): float32, a pq one ulp apart moves
# a row's sum by about its rounding; bfloat16, a pq may round one ulp (2^-8
# of it) the other way
HV_TOL = {torch.float32: 1e-6, torch.bfloat16: 2.0 ** -7}


def _hv_inputs(side: str, dt, chunked: bool, k: int = 4):
    """(lst with its weights, phi, B, seg, take, w, num): the stream of
    ``_stream`` with weights in [0.5, 1.5) (0 at the pads), its list on
    ``side``, phi over that side's rows, B over the other's."""
    u, v, w, m, n = _stream(sort=side == "u", seed=11)
    seg, take, num, rows = (u, v, m, n) if side == "u" else (v, u, n, m)
    rng = np.random.default_rng(12)
    wt = T(rng.uniform(0.5, 1.5, size=w.size) * w, dt)
    lst = _torch_list(coo_list(seg, take, w != 0, num, rows,
                               chunk=8 if chunked else XT_CHUNK), wt)
    phi = T(rng.normal(size=(num, k)), dt)
    B = T(rng.normal(size=(rows, k)), dt)
    return lst, phi, B, T(seg), T(take), wt, num


@pytest.mark.parametrize("chunked", [False, True], ids=["whole", "chunked"])
@pytest.mark.parametrize("side", ["u", "v"], ids=["sorted", "unsorted"])
@pytest.mark.parametrize("dt", list(RTOL), ids=str)
def test_pos_hv_coo_matches_the_two_call_forms(dt, side, chunked):
    """The fused Hv of a COO side is the two-call form: bit for bit the
    port's (``pos_dot`` times w, ``storage_scale`` by 1 - omega, then
    ``pos_scatter``); at float64 the JAX package's ``pos_dot`` and
    ``pos_scatter`` at rtol 1e-12, and the port's former form (the dot
    summed in torch's order) at 1e-12; at float32 / bfloat16 that former
    form within ``HV_TOL``."""
    lst, phi, B, seg, take, wt, num = _hv_inputs(side, dt, chunked)
    got = tops.pos_hv_coo(phi, B, lst, 1.0 - OMEGA)
    assert got.dtype == dt and got.shape == (num, 4)
    pq = tops.pos_dot(phi, seg, B, take) * wt
    two = tops.pos_scatter(tops.storage_scale(pq, 1.0 - OMEGA), B, lst)
    assert torch.equal(got, two)
    ids = (seg.long().clamp(max=num - 1), take.long().clamp(max=B.shape[0] - 1))
    pq_old = (phi[ids[0]] * B[ids[1]]).sum(dim=1) * wt
    old = tops.pos_scatter(tops.storage_scale(pq_old, 1.0 - OMEGA), B, lst)
    tol = 1e-12 if dt == torch.float64 else HV_TOL[dt]
    assert _max_rel(got, old.double().numpy()) <= tol
    if dt == torch.float64:
        jpq = jops.pos_dot(_J(phi), _J(seg), _J(B), _J(take)) * _J(wt)
        ref = jops.pos_scatter((1.0 - OMEGA) * jpq, _J(B), _J(take),
                               _J(seg), num, max_chunk=7 if chunked else 0,
                               seg_sorted=side == "u")
        assert _max_rel(got, ref) <= 1e-12


@pytest.mark.parametrize("k", [4, 40])
@pytest.mark.parametrize("dt", list(RTOL), ids=str)
def test_pos_dot_matches_jax(dt, k):
    """``pos_dot`` (products at storage, summed in ``_lane_dot``'s order at
    the float32 floor, rounded once; at float64 torch's sum) against the
    JAX ``pos_dot`` on the same values, ghost ids clamped, whole and
    chunked: float64 1e-12, float32 1e-6 (another order of the sum),
    bfloat16 2^-7 max-rel (the JAX sum at bfloat16 may round
    otherwise)."""
    rng = np.random.default_rng(13)
    A = T(rng.normal(size=(30, k)), dt)
    B = T(rng.normal(size=(20, k)), dt)
    u = rng.integers(0, 30, size=57).astype(np.int32)
    v = rng.integers(0, 20, size=57).astype(np.int32)
    u[-3:], v[-2:] = 30, 20  # ghost ids at the row counts
    ref = jops.pos_dot(_J(A), _J(T(u)), _J(B), _J(T(v)))
    got = tops.pos_dot(A, T(u), B, T(v))
    assert got.dtype == dt and got.shape == (57,)
    assert torch.equal(tops.pos_dot_plain(A, T(u), B, T(v), max_chunk=7),
                       got)
    tol = {torch.float64: 1e-12, torch.float32: 1e-6,
           torch.bfloat16: 2.0 ** -7}[dt]
    assert _max_rel(got, np.asarray(ref, np.float64)) <= tol
    # the order: lane l adds the products l, l + 32 in turn (storage), then
    # the xor butterfly at the float32 floor; at float64 torch's sum
    acc = tops.acc_dtype(dt)
    p = (A[u.clip(max=29)] * B[v.clip(max=19)]).to(acc)
    if dt == torch.float64:
        assert torch.equal(got, p.sum(dim=1))
        return
    p = torch.nn.functional.pad(p, (0, 64 - k) if k > 32 else (0, 32 - k))
    lane = p[:, :32] + p[:, 32:] if k > 32 else p
    for off in (16, 8, 4, 2, 1):
        lane = lane + lane[:, torch.arange(32) ^ off]
    assert torch.equal(got, lane[:, 0].to(dt))


@pytest.mark.parametrize("dt", list(RTOL), ids=str)
def test_pair_in_one_pass_equals_the_two_launch_pair(dt):
    """The pair's one pass (its weights read in list order, scaled) gives
    ``pos_scatter``'s output and the two-launch pair's second (the
    squared sums of storage_scale(w, s) read at each entry's stream
    position), bit for bit; the squared-only form gives the second alone."""
    lst, _, B, _, _, wt, _ = _hv_inputs("v", dt, True)
    rng = np.random.default_rng(14)
    c = T(rng.normal(size=wt.numel()), dt) * wt
    zpos, posq = tops.pos_scatter_pair(c, B, lst, 1.0 - OMEGA)
    assert torch.equal(zpos, tops.pos_scatter(c, B, lst))
    wq = tops.storage_scale(wt, 1.0 - OMEGA)  # stream order
    two = tops._coo_sums(lambda e: wq[lst.pos[e].long()], B, lst,
                         squared=True)
    assert torch.equal(posq, two)
    assert torch.equal(tops.pos_scatter_sq(B, lst, 1.0 - OMEGA), posq)
    assert tops.pos_scatter_pair(None, B, lst, 1.0 - OMEGA)[0] is None


# ---------------------------------------------------------------------------
# the destination-major list of the stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [8, XT_CHUNK])
@pytest.mark.parametrize("side", ["u", "v"])
def test_coo_list_invariants(side, chunk):
    """Every kept entry once, pads and ghost ids dropped; a row's entries
    in stream order, cut into chunks of at most ``chunk``; ``row`` is the
    entry's other id and ``n_rows`` the other side's rows; the X^T stage's
    plan is ``xt_plan``'s."""
    u, v, w, m, n = _stream(sort=side == "u")
    seg, take, num, rows = (u, v, m, n) if side == "u" else (v, u, n, m)
    lst = coo_list(seg, take, w != 0, num, rows, chunk=chunk)
    kept = np.nonzero(w != 0)[0]
    assert sorted(lst.pos.tolist()) == kept.tolist()
    assert lst.val is None and lst.n_rows == rows
    np.testing.assert_array_equal(lst.row, take[lst.pos])
    fptr, cptr = lst.feat_ptr, lst.chunk_ptr
    assert fptr.shape == (num + 1,) and fptr[0] == 0
    assert cptr[0] == 0 and cptr[-1] == kept.size
    assert np.all(np.diff(cptr) >= 1) and np.all(np.diff(cptr) <= chunk)
    for r in range(num):
        s, e = cptr[fptr[r]], cptr[fptr[r + 1]]
        assert np.all(seg[lst.pos[s:e]] == r)
        assert np.all(np.diff(lst.pos[s:e]) > 0)  # stream order
        assert e - s == np.sum(seg[kept] == r)
        # only the last chunk of a row is short
        assert np.all(np.diff(cptr[fptr[r]:fptr[r + 1]])[:-1] == chunk)
    for a, b in zip((lst.combine, lst.chunk_dst, lst.slot_feat),
                    xt_plan(fptr)):
        np.testing.assert_array_equal(a, b)
    hot = np.bincount(seg[kept], minlength=num).argmax()
    assert fptr[hot + 1] - fptr[hot] == -(-np.sum(seg[kept] == hot) // chunk)


def test_coo_list_refuses_a_kept_ghost_id():
    """A kept entry whose other id is outside the other side is refused;
    segment ids outside the side are dropped, as ``segment_sum`` drops
    them."""
    u, v, w, m, n = _stream(sort=True)
    keep = np.ones_like(w, bool)
    with pytest.raises(ValueError, match="other ids outside"):
        coo_list(v, u, keep, n + 1, m)  # v's ghost id is a row here
    lst = coo_list(u, v, keep, m, n)
    assert lst.pos.size == 150


# ---------------------------------------------------------------------------
# the solver: both sides COO, mixed, mixed with the head tier
# ---------------------------------------------------------------------------

MODES = ("coo", "mixed", "mixed_head")
CASES = ("mf", "ffm", "fm")
KINDS = {"mf": {"ident"}, "ffm": {"ident", "wide"}, "fm": {"wide"}}


def coo_problem(mode: str, case: str, jacobi: bool = False, seed: int = 1):
    """(problem, params, padded views, blocked_bm, head_chunk).  coo: 44
    users x 24 items, blocked_bm=0.  mixed: item 0 liked by every user, the
    v side rejected by the blocked builder at head_chunk=0 (the u side
    stays blocked).  mixed_head: user 0 likes every item (the u side takes
    the head tier at chunk 8) and the v side has 22 rows, not a multiple
    of the block.  mf: identity id fields, no self blocks; ffm: an identity
    and a small feature field per side, self blocks; fm: one mixed field
    per side with self blocks (wide under the lowered cap)."""
    m, n = 44, 22 if mode == "mixed_head" else 24
    rng = np.random.default_rng(seed)
    kw = dict(m=m, n=n, k=3, density=0.08,
              cg_precond="jacobi" if jacobi else "none")
    if case == "mf":
        prob, params = make_problem(rng, Du=(m,), Dv=(n,), self_side=False,
                                    **kw)
        _identity_field(prob, "u")
        _identity_field(prob, "v")
    elif case == "ffm":
        prob, params = make_problem(rng, Du=(m, 5), Dv=(n, 4), max_nnz=3,
                                    self_side=True, **kw)
        _identity_field(prob, "u")
        _identity_field(prob, "v")
    else:
        prob, params = make_problem(rng, Du=(m + 6,), Dv=(n + 5,),
                                    max_nnz=2, self_side=True, **kw)
        for Xs, fr, rows in ((prob.Xu, prob.freq_u, m),
                             (prob.Xv, prob.freq_v, n)):
            Xs[0][:, :rows] = np.eye(rows)
            fr[0][:] = Xs[0].astype(bool).sum(axis=0)
    pos = prob.pos.copy()
    if mode == "mixed":
        pos[:, 0] = True
    elif mode == "mixed_head":
        pos[0, :] = True
    prob = dataclasses.replace(prob, pos=pos)
    views = padded(prob, multiple=2 if mode == "mixed_head" else 4)
    bm = 0 if mode == "coo" else BM
    return prob, params, views, bm, CHUNK if mode == "mixed_head" else 0


# (blocked u?, blocked v?, head tier on u?) per mode
SIDES = {"coo": (False, False, False), "mixed": (True, False, False),
         "mixed_head": (True, False, True)}


@pytest.fixture
def cap(monkeypatch):
    """The lowered fused cap on both sides for FM."""
    def apply(case):
        if case == "fm":
            monkeypatch.setattr(torch_solver, "FUSED_TBL_D", CAP)
            monkeypatch.setenv("OCFFM_FUSED_TBL_D", str(CAP))
    return apply


def port(mode, case, jacobi=False, seed=1, dtype=torch.float64):
    prob, params, (u, v, y), bm, hc = coo_problem(mode, case, jacobi, seed)
    meta, data = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=dtype, blocked_bm=bm,
        head_chunk=hc, device="cpu")
    solver = torch_solver.FFMSolver(meta, data)
    bu, bv, hu = SIDES[mode]
    assert (bool(meta.blocked_bm_u), bool(meta.blocked_bm_v), solver.hd_u) \
        == (bu, bv, hu)
    assert not solver.hd_v
    p_np = {f12: {"W": params["W"][f12], "H": params["H"][f12]}
            for f12 in params["W"]}
    state = solver.refresh_caches(
        {"params": params_from_numpy(p_np, "cpu", dtype)})
    return prob, params, solver, state


def jax_solver_for(mode, case, jacobi, seed, monkeypatch):
    """The JAX solver on the same problem, its kernels in interpret mode
    with the per-solve pregather forced (tests/test_torch_two_tier.py
    jax_two_tier); OCFFM_HEAD_CHUNK as the port's head_chunk."""
    prob, params, (u, v, y), bm, hc = coo_problem(mode, case, jacobi, seed)
    monkeypatch.setenv("OCFFM_KT", "interpret")
    monkeypatch.setenv("OCFFM_FUSED_TBL", "interpret")
    monkeypatch.setenv("OCFFM_BLK_PREGATHER", "1")
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", str(hc))
    meta, data = jax_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=jnp.float64, blocked_bm=bm)
    solver = jax_solver.FFMSolver(meta, data)
    state = solver.refresh_caches({"params": oracle_params_to_jax(params)})
    return solver, state


def _kinds(solver, prob):
    out = set()
    for b in prob.layout.all_blocks():
        for first in (True, False):
            xf = solver._x(b, first)[2]
            out.add("ident" if xf is None else
                    "fused" if solver._fused(b, first) else "wide")
    return out


@pytest.mark.parametrize("mode", MODES)
def test_device_data_coo_side(mode, monkeypatch):
    """A COO side's order is the stream: identity src and inv, w = pos_w,
    take and seg the other side's and its own ids (0 at the pads), its
    list of the stream; the cross-order maps of the other side index the
    stream; no fused field on it.  blocked_bm_u / _v as the JAX
    package's."""
    prob, _, (u, v, y), bm, hc = coo_problem(mode, "ffm")
    meta, d = torch_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=torch.float64, blocked_bm=bm,
        head_chunk=hc, device="cpu")
    monkeypatch.setenv("OCFFM_HEAD_CHUNK", str(hc))
    jmeta, jd = jax_solver.make_device_data(
        u, v, y, prob.layout, prob.hp, dtype=jnp.float64, blocked_bm=bm)
    assert (meta.blocked_bm_u, meta.blocked_bm_v) == (jmeta.blocked_bm_u,
                                                      jmeta.blocked_bm_v)
    nnz = y.w.shape[0]
    pads = y.w == 0
    for s, oth, bmx in (("u", "v", meta.blocked_bm_u),
                        ("v", "u", meta.blocked_bm_v)):
        if bmx:
            assert "coo_" + s not in d
            continue
        pre = f"blk_{s}_"
        ids = {"u": y.u, "v": y.v}
        np.testing.assert_array_equal(d[pre + "src"].numpy(), np.arange(nnz))
        np.testing.assert_array_equal(d[pre + "inv"].numpy(), np.arange(nnz))
        assert d[pre + "w"] is d["pos_w"]
        np.testing.assert_array_equal(d[pre + "take"].numpy(),
                                      np.where(pads, 0, ids[oth]))
        np.testing.assert_array_equal(d[pre + "seg"].numpy(),
                                      np.where(pads, 0, ids[s]))
        lst = d["coo_" + s]
        assert sorted(lst.pos.tolist()) == np.nonzero(~pads)[0].tolist()
        # its weights in list order (w at each entry's stream position)
        assert torch.equal(lst.val, d["pos_w"][lst.pos.long()])
        assert lst.feat_ptr.numel() == (u.m if s == "u" else v.m) + 1
        assert not any(meta.fused_u if s == "u" else meta.fused_v)
        # the other side's map into this side's order: its src (stream
        # positions), head slots included
        np.testing.assert_array_equal(d[f"blk_{oth}_from_{s}"].numpy(),
                                      d[f"blk_{oth}_src"].numpy())
        if f"blk_{oth}_hd_src" in d:
            np.testing.assert_array_equal(
                d[f"blk_{oth}_hd_from_{s}"].numpy(),
                d[f"blk_{oth}_hd_src"].numpy())
    if mode != "coo":  # the blocked u side keeps its fused field
        assert meta.fused_u == (False, True)


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mode", MODES)
def test_gradient_hv_and_diagonal_match_oracle(mode, case, jacobi, cap):
    """Every block side: the gradient, Hv and (Jacobi) the Hessian diagonal
    against the fp64 oracle at 1e-6; a cross solve on a COO side gathers
    no stream."""
    cap(case)
    prob, params, solver, state = port(mode, case, jacobi)
    assert _kinds(solver, prob) >= KINDS[case]
    sa, sb = solver.sasb(state)
    rng = np.random.default_rng(3)
    for b in prob.layout.all_blocks():
        for first in (True, False):
            G, hv, rows_pre, _, D = solver.solve_inputs(state, b, first, sa,
                                                        sb)
            if b.kind == "uv":
                coo = solver._coo(first) is not None
                assert (rows_pre is None) == coo
            G_ref, hv_ref = oracle.grad_and_hv(prob, params, b, first)
            msg = f"{b.f12} {first}"
            np.testing.assert_allclose(G.numpy(), G_ref, rtol=1e-6,
                                       atol=1e-10, err_msg=msg)
            V = rng.normal(size=G_ref.shape)
            np.testing.assert_allclose(hv(T(V)).numpy(), hv_ref(V),
                                       rtol=1e-6, atol=1e-10, err_msg=msg)
            if jacobi:
                D_ref = oracle.diag_hessian(prob, params, b, first)
                np.testing.assert_allclose(D.numpy(), D_ref, rtol=1e-6,
                                           atol=1e-10, err_msg=msg)
                if b.kind == "uv" and solver._coo(first) is not None:
                    # the diagonal's own COO pass, without the gradient's:
                    # the same formula, so the same bits
                    assert torch.equal(solver._diag_H(state, b, first), D)
            else:
                assert D is None


@pytest.mark.parametrize("jacobi", [False, True], ids=["plain", "jacobi"])
@pytest.mark.parametrize("mode", MODES)
def test_two_epochs_match_oracle(mode, jacobi, cap):
    """FFM: two epochs' tables and objective against the oracle's epochs
    (rtol 1e-6); on the CPU no kernel launches."""
    prob, params, solver, state = port(mode, "ffm", jacobi)
    kernels.reset_launch_counts()
    ref = params
    for _ in range(2):
        ref = oracle.oracle_epoch(prob, ref)
        state = solver.epoch(state)
    for f12 in ref["W"]:
        for name in ("W", "H"):
            np.testing.assert_allclose(
                state["params"][f12][name].numpy(), ref[name][f12],
                rtol=1e-6, atol=1e-9, err_msg=f"{name} {f12}")
    np.testing.assert_allclose(float(solver.objective(state)),
                               oracle.objective(prob, ref), rtol=1e-6)
    assert sum(kernels.launch_counts().values()) == 0


# both-COO and mixed over every case, plain and Jacobi; the head tier's
# mixed mode on the FFM, plain CG (the oracle tests hold its other cases)
CG_CASES = [pytest.param(mode, case, jacobi,
                         id=f"{mode}-{case}-{'jacobi' if jacobi else 'plain'}")
            for mode in ("coo", "mixed") for case in CASES
            for jacobi in (False, True)] + [
    pytest.param("mixed_head", "ffm", False, id="mixed_head-ffm-plain")]


@pytest.mark.parametrize("mode, case, jacobi", CG_CASES)
def test_cg_counts_match_jax(mode, case, jacobi, cap, monkeypatch):
    """Against the JAX solver on the same sides (its plain COO solver, or
    its mixed mode with the stream-order carry): equal CG counts per solve
    over two epochs, tables and the stream residual within 1e-6 of their
    largest entry (the two sum in other orders, and a solve of a few CG
    iterations on a near-singular direction carries a 1e-14 difference of
    its gradient to 1e-10 of its step, as on the mixed FM's v self
    block)."""
    cap(case)
    _, _, tsolver, tst = port(mode, case, jacobi, seed=4)
    jsolver, jst = jax_solver_for(mode, case, jacobi, 4, monkeypatch)
    assert (jsolver.meta.blocked_bm_u, jsolver.meta.blocked_bm_v) == (
        tsolver.meta.blocked_bm_u, tsolver.meta.blocked_bm_v)
    assert (jsolver.hd_u, jsolver.hd_v) == (tsolver.hd_u, tsolver.hd_v)
    assert not jsolver.blk_yt
    assert tsolver.cg_precond == jsolver.cg_precond
    for _ in range(2):
        tst, t_it = tsolver.epoch_stats(tst)
        jst, j_it = jsolver.epoch_stats(jst)
        np.testing.assert_array_equal(t_it.numpy(), np.asarray(j_it))
        assert t_it.sum() > 0
    for f12 in jst["params"]:
        for name in ("W", "H"):
            assert _max_rel(tst["params"][f12][name],
                            jst["params"][f12][name]) <= 1e-6, (name, f12)
    assert _max_rel(tsolver.yt_stream(tst), jsolver.yt_stream(jst)) <= 1e-6


@pytest.mark.parametrize("mode", MODES)
def test_carry_after_two_epochs_equals_refresh(mode, cap):
    """After two epochs the carried residual of both sides (a COO side's
    in stream order, a head tier's slots) equals a fresh
    ``refresh_caches`` of the advanced tables."""
    cap("fm")
    _, _, solver, state = port(mode, "fm")
    for _ in range(2):
        state = solver.epoch(state)
    re = solver.refresh_caches({"params": state["params"]})
    keys = [key for key in re if key.startswith("yt_")]
    assert len(keys) == 2 + solver.hd_u
    for key in keys:
        assert re[key].shape == state[key].shape, key
        np.testing.assert_allclose(re[key].numpy(), state[key].numpy(),
                                   rtol=1e-8, atol=1e-10, err_msg=key)
    np.testing.assert_allclose(float(solver.objective(re)),
                               float(solver.objective(state)), rtol=1e-10)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=str)
def test_coo_epoch_at_storage_dtypes(dt):
    """Both sides COO at float32 and bfloat16 storage: an epoch runs, the
    objective falls and stays finite, and a repeat gives the same bits."""
    _, _, solver, state = port("coo", "ffm", dtype=dt)
    before = float(solver.objective(state))
    a, ia = solver.epoch_stats(state)
    b, ib = solver.epoch_stats(state)
    assert torch.equal(ia, ib)
    for key in ("yt_u", "yt_v", "a", "b"):
        assert a[key].dtype == dt and torch.equal(a[key], b[key]), key
    after = float(solver.objective(a))
    assert np.isfinite(after) and after < before


# ---------------------------------------------------------------------------
# chip_smoke's COO phases on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_coo_rehearsal_on_cpu(capsys):
    """chip_smoke's two new main paths at toy size: the FFM with
    ``blocked_bm=0`` (both sides COO) and the skewed FFM with
    ``head_chunk=0`` under Jacobi (the v side COO, the u side blocked).
    Their kernel cases record nothing on the CPU, each trains and
    validates, and one epoch repeats bit for bit; the COO ops' work and
    library yardsticks (the list passes' and ``pos_dot``'s sampled product,
    in its CSR order of the real pairs) run on their recorded
    arguments."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    ffm = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                dims_v=(120, 20), self_side=True)
    skew = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True,
                                 pop_skew=1.0)
    coo = chip_smoke.make_trainer(ffm, "cpu", k=4, blocked_bm=0)
    mixed = chip_smoke.make_trainer(skew, "cpu", k=4, blocked_bm=8,
                                    head_chunk=0, cg_precond="jacobi")
    assert chip_smoke.coo_sides(coo.solver) == "u and v"
    assert chip_smoke.coo_sides(mixed.solver) == "v"
    paths = (("FFM coo", coo, chip_smoke.coo_cases(coo)),
             ("FFM skew-coo", mixed, chip_smoke.skew_coo_cases(mixed)))
    assert {n for _, _, cases in paths for case in cases
            for n in case[0]} == set(chip_smoke.COO + chip_smoke.DOT
                                     + chip_smoke.WIDE)
    for tag, tr, cases in paths:
        state = tr.init_state()
        for names_, b, first, _ in cases:
            with chip_smoke.recorded(torch_solver, names_,
                                     first_only=True) as calls:
                tr.solver._solve_half(state, b, first,
                                      *tr.solver.sasb(state))
            for name in names_:
                assert calls[name], (tag, name)
                args, _ = calls[name][0]
                got = getattr(tops, name)(*args)
                nbytes, nops = chip_smoke.work(name, args, got)
                assert nbytes > 0 and nops > 0
                lib = chip_smoke.library_call(name, args)
                if lib is None:  # the fused Hv: no one call
                    assert name == "pos_hv_coo"
                    continue
                ref = lib()
                if name == "pos_dot":
                    A, u, B, v = args[:4]
                    keep = (u < A.shape[0]) & (v < B.shape[0])
                    order = torch.argsort(u[keep].long() * B.shape[0]
                                          + v[keep].long())
                    got, ref = got[keep][order], ref.values()
                got0 = got[0] if isinstance(got, tuple) else got
                ref0 = ref[0] if isinstance(ref, tuple) else ref
                np.testing.assert_allclose(got0.double().numpy(),
                                           ref0.double().numpy(),
                                           rtol=1e-4, atol=1e-5)
        res = chip_smoke.train_and_validate(tr, epochs=3)
        chip_smoke.check_main_path(res)
        chip_smoke.check_repeatable(tag, tr)
