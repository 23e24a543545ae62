"""How close a mesh's float32 half-solves come to one process's, and to
the float64 value of the same state.

For the headline FFM with both sides COO (``coo``) and blocked
(``blocked``): one process trains one epoch (float32, on the given
device); from that state each pick of ``chip_smoke.mesh_picks`` (the
cross blocks on both sides, the user and item self blocks) gives the
gradient G, one Hv and the step T: in float32 on one process, in float64
on the CPU from the same state (the plain versions), and on each rank of
a 2-rank data mesh (gloo, the ranks sharing the device).  Each line
prints max|d|/max|ref| of one process against float64, of each rank
against float64 and against one process, and the CG counts.  The
``term`` lines are this script's own float32 forms of the sums the
gradients are built from (the item self block's sum(a), sb, its dense and
positive z; the cross blocks' k-vectors, Grams and dense term), each
rank's rows against one process's and against float64.

    python3 mesh_accuracy.py [cuda:0|cpu] [n_users n_items]

Full width (200,000 x 20,000) by default; give a device with a small size
on the CPU, e.g. ``cpu 40000 4000``.

    python3 mesh_accuracy.py trace [cuda:0|cpu] [n_users n_items]
    python3 mesh_accuracy.py dtypes [cuda:0|cpu] [n_users n_items [epochs]]
    python3 mesh_accuracy.py bf16-sizes [cuda:0|cpu] [NxM ...]

``trace``: the headline FFM of ``[mesh ffm]`` (one process on the flat
stream, 2 data ranks on the shard-aligned one, both from the seed's
tables) stepped half-solve by half-solve through 2 epochs, each run on
its own.  After each half-solve it prints, per rank, the updated table's
max|d|/max|ref| against the one process's and the worst over all tables,
both CG counts, whether each solve stopped at the cap
(``cg_max_iter``), whether the counts differ (a stop-rule flip) and the
smallest margin of a stop test ``r2 > cg_eps * g2`` in either run (in
units of the float32 epsilon: a flip of the rounding decides a test within
one or two).  Then the objectives and the tables' distance after each
epoch: where the model file's distance comes from.

``dtypes`` (ROADMAP C3): one process, MF ``--ns`` on ``[bf16 mf]``'s data
(k=32, 5 positives per user) at float32 and bfloat16 storage from the
seed's tables, stepped half-solve by half-solve (``dtype_trace``): after
each, per dtype, the CG count, the gradient's norm and the last stop test,
the objective at the solver's dtype, of its carried state at float64 and
of its tables at float64, the carried residual's distance from the one
re-derived from the tables; the bf16 table's distance from the float32
one; the AUC after each epoch.  ``bf16-sizes``: ``[bf16 mf]`` (11 epochs
of each dtype, the AUC after each; the divergence tripwire off) at each
size given.
"""
import os
import pickle
import sys
import types

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def terms(solver, state):
    """This script's float32 forms of the sums the item self block's and
    the first two cross blocks' v-side gradients are built from."""
    from one_class_ffm_torch.ops.sparse_ops import (
        pos_scatter,
        pos_seg_sum,
        seg_sum_blocked,
    )
    meta, d = solver.meta, solver.data
    hp = meta.hp
    sa, sb = solver.sasb(state)
    out = {}
    sum_a = solver._allreduce(state["a"].sum(), "sums")
    out["sum_a"] = np.array([float(sum_a)])
    out["sb"] = sb
    out["b"] = state["b"]
    c_v = solver._pos_coeff(state["yt_v"]) * d["blk_v_w"]
    coo = solver._coo(False)
    out["zpos_vv"] = (seg_sum_blocked(c_v, d["blk_v_own"], solver.n_l,
                                      meta.blocked_bm_v)
                      if coo is None else pos_seg_sum(c_v, coo))
    out["zdense_vv"] = hp.omega * (meta.m_true * (state["b"] - hp.r)
                                   + sum_a + sb)
    cross = meta.layout.cross_blocks()
    for i, blk in enumerate(cross[:2]):
        B1 = state["P"][blk.f12]
        red = solver._allreduce_many(
            [B1.sum(dim=0), B1.T @ state["a"]]
            + [state["P"][x.f12].T @ B1 for x in cross], "gram")
        out[f"oQ{i}"], out[f"bQ{i}"] = red[0], red[1]
        out[f"gram{i}"] = torch.stack(red[2:])
        gram_T = sum(state["Q"][x.f12] @ red[2 + j]
                     for j, x in enumerate(cross))
        out[f"dense{i}"] = hp.omega * ((state["b"] - hp.r)[:, None]
                                       * red[0][None, :] + red[1][None, :]
                                       + gram_T)
        if coo is not None:
            Bs = solver._gather(B1, "check")
            out[f"zpos{i}"] = pos_scatter(c_v, Bs, coo)
    return {k: (v if isinstance(v, np.ndarray)
                else v.double().cpu().numpy()) for k, v in out.items()}


def rank_fn(state_path, picks, device, spec):
    """One rank: the one-process state at ``state_path`` placed on its part
    of the 2-rank mesh, its terms and half-solves."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(2)
    data = cs._mesh_data(spec, 2)
    trainer = cs.make_trainer(data, device, epochs=1, mesh_shape="2",
                              distributed=True, **spec["trainer"])
    with open(state_path, "rb") as fh:
        state = trainer._place_state(pickle.load(fh))
    return dict(rank=trainer.mesh.rank, n_l=trainer.solver.n_l,
                terms=terms(trainer.solver, state),
                halves=cs.half_solve_outputs(trainer.solver, state, picks))


def cast64(x):
    if isinstance(x, dict):
        return {k: cast64(v) for k, v in x.items()}
    if torch.is_tensor(x) and x.is_floating_point():
        return x.double().cpu()
    if torch.is_tensor(x):
        return x.cpu()
    return x


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)


def run(kind, device, nu, ni):
    """Print the comparison of one layout (``coo`` or ``blocked``) at
    ``nu`` x ``ni``; returns {(pick, "G" | "Hv" | "T"): {"one_vs_64",
    "mesh_vs_one"}}, the worst rank's."""
    from one_class_ffm_torch.parallel.distributed import spawn
    from one_class_ffm_torch.parallel.mesh import host_arrays

    base = cs.MESH_SPEC if kind == "blocked" else cs.MESH_PATHS[kind]
    spec = dict(base, tag="accuracy " + kind, n_users=nu, n_items=ni,
                ref_shards=2, epochs=1,
                dims=(cs.FFM_DIMS if nu == cs.N_USERS
                      else dict(dims_u=(nu, 1000), dims_v=(ni, 500))))
    work = os.path.join(cs.WORK, "accuracy_" + kind)
    os.makedirs(work, exist_ok=True)
    data = cs._mesh_data(spec, 2)
    ref = cs.make_trainer(data, torch.device(device), epochs=1,
                          **spec["trainer"])
    solver = ref.solver
    state1, _ = solver.epoch_stats(ref.init_state())
    picks = cs.mesh_picks(solver, True)
    t32 = terms(solver, state1)
    h32 = cs.half_solve_outputs(solver, state1, picks)
    ref64 = cs.make_trainer(data, torch.device("cpu"), dtype="float64",
                            epochs=1, **spec["trainer"])
    s64 = cast64(state1)
    t64 = terms(ref64.solver, s64)
    h64 = cs.half_solve_outputs(ref64.solver, s64, picks)
    path = os.path.join(work, "state1.pkl")
    with open(path, "wb") as fh:
        pickle.dump(host_arrays(state1), fh, protocol=4)
    del state1
    outs = spawn("mesh_accuracy:rank_fn", 2, args=(path, picks, device, spec),
                 backend="gloo", workdir=work, timeout=900)
    print(f"== {kind} {nu}x{ni} on {device}")
    errs = {}
    for label, _, _ in picks:
        for key in ("G", "Hv", "T"):
            w64 = h64[label][key]
            errs[label, key] = dict(
                one_vs_64=rel(h32[label][key], w64),
                mesh_vs_one=max(rel(o["halves"][label][key],
                                    h32[label][key]) for o in outs))
            print(f"{kind} {label:12s} {key:2s} one32-vs-64 "
                  f"{rel(h32[label][key], w64):.3e} " + " ".join(
                      f"rank{o['rank']}-vs-64 "
                      f"{rel(o['halves'][label][key], w64):.3e} "
                      f"rank{o['rank']}-vs-one32 "
                      f"{rel(o['halves'][label][key], h32[label][key]):.3e}"
                      for o in outs) + f" CG {h32[label]['iters']} / "
                  f"{[o['halves'][label]['iters'] for o in outs]} "
                  f"max|ref| {float(np.abs(w64).max()):.4e}")
    for name in t32:
        line = (f"{kind} term {name:10s} one32-vs-64 "
                f"{rel(t32[name], t64[name]):.3e} max|64| "
                f"{float(np.abs(t64[name]).max()):.4e}")
        for o in outs:
            got = o["terms"][name]
            w32, w64 = t32[name], t64[name]
            if got.shape != w32.shape:  # row-sharded: the rank's rows
                n = got.shape[0]
                w32 = w32[o["rank"] * n:(o["rank"] + 1) * n]
                w64 = w64[o["rank"] * n:(o["rank"] + 1) * n]
            line += (f" rank{o['rank']}-vs-one32 {rel(got, w32):.3e} "
                     f"-vs-64 {rel(got, w64):.3e}")
        print(line)
    sys.stdout.flush()
    return errs


# ---------------------------------------------------------------------------
# trace: one process and the 2-rank mesh, half-solve by half-solve
# ---------------------------------------------------------------------------

TRACE_EPOCHS = 2


def _traced_cg_loop(tests):
    """``FFMSolver._cg_loop`` under plain CG, which also appends each stop
    test's (r2, cg_eps * g2) to ``tests``: the same operations in the same
    order (the loop already reads the test on the host)."""
    def loop(self, hv, G, D=None):
        import torch

        assert D is None, "trace: plain CG only"
        hp = self.meta.hp
        storage = self.meta.dtype
        ct = torch.promote_types(G.dtype, torch.float32)
        Gc = G.to(ct)
        g2 = (Gc * Gc).sum()
        S = torch.zeros_like(Gc)
        R = -Gc
        V = -Gc
        r2 = g2
        rz = g2
        it = 0
        one = torch.ones((), dtype=ct, device=Gc.device)
        zero = torch.zeros((), dtype=ct, device=Gc.device)
        while True:
            thr = hp.cg_eps * g2
            tests.append((float(r2), float(thr)))
            if not (it < hp.cg_max_iter and bool(r2 > thr)):
                break
            Hv = hv(V.to(storage)).to(ct)
            den = (V * Hv).sum()
            ok = den > 0
            alpha = torch.where(ok, rz / torch.where(ok, den, one), zero)
            S = S + alpha * V
            R = R - alpha * Hv
            r2_new = torch.where(ok, (R * R).sum(), zero)
            rz_safe = torch.where(rz > 0, rz, one)
            rz_new = r2_new
            V = R + (rz_new / rz_safe) * V
            r2, rz = r2_new, rz_new
            it += 1
        return S, it
    return loop


def trace_epochs(solver, state, epochs, reference=None):
    """Step ``epochs`` epochs half-solve by half-solve (``_epoch_impl``'s
    order, sa/sb once per epoch).  Returns per half-solve its CG count and
    stop tests, and either the updated table (``reference`` None) or its
    distance and the worst table's against ``reference``'s tables after the
    same half-solve; and the objective after each epoch."""
    import numpy as np

    tests = []
    solver._cg_loop = types.MethodType(_traced_cg_loop(tests), solver)
    blocks = solver.meta.layout.epoch_order()
    tables = {(b.f12, n): None for b in blocks for n in ("W", "H")}
    dist = dict.fromkeys(tables, 0.0)
    rows, objectives, h = [], [], 0
    for ep in range(epochs):
        sa, sb = solver.sasb(state)
        for b in blocks:
            for first in (True, False):
                tests.clear()
                state, it = solver._solve_half(state, b, first, sa, sb)
                key = (b.f12, "W" if first else "H")
                T = solver.full_params(state["params"])[b.f12][key[1]]
                T = T.float().cpu().numpy()
                row = dict(epoch=ep + 1, f12=b.f12, kind=b.kind,
                           table=key[1], iters=int(it), tests=list(tests))
                if reference is None:
                    row["T"] = T
                else:
                    dist[key] = rel(T, reference[h]["T"])
                    row["dist"] = dist[key]
                    row["worst"] = max(dist.values())
                rows.append(row)
                h += 1
        objectives.append(float(solver.objective(state)))
    return state, rows, objectives


def trace_rank(state_path, ref_path, device, spec):
    """One rank of ``trace``: the seed's state placed on its part of the
    2-rank mesh, stepped as the one process was, against its tables."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.set_num_threads(2)
    data = cs._mesh_data(spec, 2)
    trainer = cs.make_trainer(data, device, epochs=TRACE_EPOCHS,
                              mesh_shape="2", distributed=True)
    with open(state_path, "rb") as fh:
        state = trainer._place_state(pickle.load(fh))
    with open(ref_path, "rb") as fh:
        reference = pickle.load(fh)
    _, rows, objectives = trace_epochs(trainer.solver, state, TRACE_EPOCHS,
                                       reference)
    return dict(rank=trainer.mesh.rank, rows=rows, objectives=objectives)


def _min_margin(tests):
    """The smallest |r2 - cg_eps*g2| / (cg_eps*g2) over a solve's stop
    tests, in float32 epsilons."""
    eps = 2.0 ** -23
    return min((abs(r2 - thr) / thr / eps for r2, thr in tests if thr > 0),
               default=float("inf"))


def trace(device, nu, ni):
    """Print the half-solve trace of the 2-rank data mesh against one
    process (see the module docstring); returns the rows."""
    import torch

    from one_class_ffm_torch.parallel.distributed import spawn
    from one_class_ffm_torch.parallel.mesh import host_arrays

    spec = dict(cs.MESH_SPEC, tag="trace", n_users=nu, n_items=ni,
                dims=(cs.FFM_DIMS if nu == cs.N_USERS
                      else dict(dims_u=(nu, 1000), dims_v=(ni, 500))))
    work = os.path.join(cs.WORK, "accuracy_trace")
    os.makedirs(work, exist_ok=True)
    ref = cs.make_trainer(cs._mesh_data(spec, spec["ref_shards"]),
                          torch.device(device), epochs=TRACE_EPOCHS)
    state0 = ref.init_state()
    state_path = os.path.join(work, "state0.pkl")
    with open(state_path, "wb") as fh:
        pickle.dump(host_arrays(state0), fh, protocol=4)
    # the traced loop against the solver's own: the same epochs, bit for bit
    plain = state0
    for _ in range(TRACE_EPOCHS):
        plain, _ = ref.solver.epoch_stats(plain)
    plain = {f12: {n: t.float().cpu().numpy() for n, t in blk.items()}
             for f12, blk in ref.solver.full_params(plain["params"]).items()}
    final, rows, objectives = trace_epochs(ref.solver, state0, TRACE_EPOCHS)
    same = all(np.array_equal(t.float().cpu().numpy(), plain[f12][n])
               for f12, blk in ref.solver.full_params(
                   final["params"]).items() for n, t in blk.items())
    ref_path = os.path.join(work, "one_process.pkl")
    with open(ref_path, "wb") as fh:
        pickle.dump([dict(T=r["T"]) for r in rows], fh, protocol=4)
    outs = spawn("mesh_accuracy:trace_rank", 2,
                 args=(state_path, ref_path, device, spec), backend="gloo",
                 workdir=work, timeout=1200)
    cap = ref.solver.meta.hp.cg_max_iter
    print(f"== trace {nu}x{ni} on {device}: one process (flat stream) vs 2 "
          f"data ranks (shard-aligned), from the seed's tables; the traced "
          f"CG loop gives the solver's own tables: {same}")
    print("trace  h ep block kind tbl   CG one / ranks   cap   flip "
          "margin(eps32) one / ranks   table dist / worst per rank")
    for h, r in enumerate(rows):
        got = [o["rows"][h] for o in outs]
        its = [g["iters"] for g in got]
        capped = (r["iters"] >= cap, [i >= cap for i in its])
        flip = any(i != r["iters"] for i in its)
        margins = " ".join(f"{_min_margin(g['tests']):.3g}" for g in got)
        dists = " ".join(f"{g['dist']:.3e} / {g['worst']:.3e}" for g in got)
        print(f"trace {h:2d} {r['epoch']:2d} {str(r['f12']):>7s} "
              f"{r['kind']:4s} {r['table']:3s} {r['iters']:2d} / {its} "
              f"{capped[0]!s:5s}/{capped[1]} {flip!s:5s} "
              f"{_min_margin(r['tests']):.3g} / {margins}   {dists}")
    for ep in range(TRACE_EPOCHS):
        worst = [max(g["worst"] for g in o["rows"] if g["epoch"] == ep + 1)
                 for o in outs]
        print(f"trace epoch {ep + 1}: objective one process "
              f"{objectives[ep]:.6f}, ranks "
              f"{[o['objectives'][ep] for o in outs]}; worst table "
              f"distance per rank {[f'{w:.3e}' for w in worst]}")
    sys.stdout.flush()
    return rows, outs


# ---------------------------------------------------------------------------
# dtypes: one process, float32 and bfloat16 storage side by side
# ---------------------------------------------------------------------------

DTYPE_EPOCHS = 6


def _dtype_stats(solver, state, ref64):
    """The tracked and recomputed quantities of one state: the objective of
    the carried caches and residual, evaluated at float64 (``ref64``'s
    solver on the CPU), the objective of the tables alone (caches and
    residual re-derived from them at float64), and the carried residual's
    distance from the one re-derived at the state's own dtype
    (``refresh_caches``): max and mean |d| over the real slots of each
    side."""
    st64 = {k: cast64(v) for k, v in state.items()}
    st64["params"] = cast64(solver.full_params(state["params"]))
    s64 = ref64.solver
    tracked = float(s64.objective(st64))
    exact = float(s64.objective(s64.refresh_caches(
        {"params": st64["params"]})))
    fresh = solver.refresh_caches({"params": state["params"]})
    carry = {}
    for s in ("u", "v"):
        w = solver.data[f"blk_{s}_w"] > 0
        dlt = (state["yt_" + s].double() - fresh["yt_" + s].double())[w]
        carry[s] = (float(dlt.abs().max()), float(dlt.abs().mean()))
    return dict(tracked=tracked, exact=exact, carry=carry,
                own=float(solver.objective(state)))


def dtype_trace(device, nu, ni, epochs=DTYPE_EPOCHS):
    """MF ``--ns`` at ``nu`` x ``ni`` (``[bf16 mf]``'s data, k=32), float32
    and bfloat16 storage from the seed's tables, stepped half-solve by
    half-solve; the AUC after each epoch.  Returns the rows."""
    import dataclasses

    device = torch.device(device)
    data = cs.build_data(nu, ni, 5.0, seed=0)
    trs = {dt: cs.make_trainer(data, device, dtype=dt, epochs=epochs)
           for dt in ("float32", "bfloat16")}
    ref64 = cs.make_trainer(data, torch.device("cpu"), dtype="float64",
                            epochs=epochs)
    states = {dt: tr.init_state() for dt, tr in trs.items()}
    tests = {dt: [] for dt in trs}
    for dt, tr in trs.items():
        tr.solver._cg_loop = types.MethodType(_traced_cg_loop(tests[dt]),
                                              tr.solver)
    blocks = ref64.solver.meta.layout.epoch_order()
    cap = ref64.solver.meta.hp.cg_max_iter
    eps = ref64.solver.meta.hp.cg_eps
    print(f"== dtypes MF --ns {nu}x{ni}, k=32 on {device}: float32 and "
          f"bfloat16 storage from the seed's tables, half-solve by "
          f"half-solve.  obj: own = the solver's objective at its dtype; "
          f"tracked = of its carried caches and residual at float64; exact "
          f"= of its tables at float64.  carry: max / mean |yt carried - yt "
          f"re-derived| per side.  |G|: the gradient's norm; r2/g2: the "
          f"solve's last stop test (cg_eps {eps}).")
    rows = []
    h = 0
    for ep in range(1, epochs + 1):
        sas = {dt: trs[dt].solver.sasb(states[dt]) for dt in trs}
        for b in blocks:
            for first in (True, False):
                row = dict(h=h, epoch=ep, table="W" if first else "H")
                for dt, tr in trs.items():
                    tests[dt].clear()
                    states[dt], it = tr.solver._solve_half(
                        states[dt], b, first, *sas[dt])
                    r2, thr = tests[dt][-1]
                    row[dt] = dict(_dtype_stats(tr.solver, states[dt],
                                                ref64),
                                   iters=int(it), g=(thr / eps) ** 0.5,
                                   r2g2=r2 / (thr / eps) if thr else 0.0)
                key = "W" if first else "H"
                t32, t16 = (trs[dt].solver.full_params(
                    states[dt]["params"])[b.f12][key].double().cpu().numpy()
                    for dt in ("float32", "bfloat16"))
                row["dist"] = rel(t16, t32)
                rows.append(row)
                for dt in trs:
                    r = row[dt]
                    print(f"dtypes {h:2d} ep {ep:2d} {row['table']} {dt:8s} "
                          f"CG {r['iters']:2d}{' cap' if r['iters'] >= cap else ''}"
                          f" |G| {r['g']:.4e} r2/g2 {r['r2g2']:.3e} obj own "
                          f"{r['own']:.6e} tracked {r['tracked']:.6e} exact "
                          f"{r['exact']:.6e} carry u {r['carry']['u'][0]:.3e}"
                          f" / {r['carry']['u'][1]:.3e} v "
                          f"{r['carry']['v'][0]:.3e} / "
                          f"{r['carry']['v'][1]:.3e}")
                print(f"dtypes {h:2d} ep {ep:2d} {row['table']} bf16 table "
                      f"vs f32 {row['dist']:.4e}")
                h += 1
        aucs = {}
        for dt, tr in trs.items():
            tr.state, tr.epoch_idx = states[dt], ep
            tr.cfg = dataclasses.replace(tr.cfg, nr_pass=ep)
            aucs[dt] = tr.validate()["auc"]
        print(f"dtypes epoch {ep}: AUC float32 {aucs['float32']:.4f} "
              f"bfloat16 {aucs['bfloat16']:.4f}")
        sys.stdout.flush()
    return rows


if __name__ == "__main__":
    args = sys.argv[1:]
    mode = (args.pop(0) if args and args[0] in ("trace", "dtypes",
                                                 "bf16-sizes")
            else "accuracy")
    if mode == "bf16-sizes":
        dev = torch.device(args[0] if args else "cuda:0")
        gpu = cs.gpu_line() if dev.type == "cuda" else "cpu"
        if dev.type == "cpu":
            torch.set_num_threads(4)
        for size in args[1:] or [f"{cs.N_USERS}x{cs.N_ITEMS}"]:
            nu, ni = (int(x) for x in size.split("x"))
            print(f"== bf16-sizes MF --ns {nu}x{ni}, k=32, 5 positives per "
                  f"user on {dev}")
            cs.bf16_mf_phase(cs.build_data(nu, ni, 5.0, seed=0), dev, gpu,
                             nan_guard=False)
            sys.stdout.flush()
        sys.exit(0)
    if mode == "dtypes":
        dev = args[0] if args else "cuda:0"
        if dev.startswith("cuda"):
            print("[device]", cs.gpu_line())
        else:
            torch.set_num_threads(4)
        nu, ni = ((int(args[1]), int(args[2])) if len(args) > 2
                  else (cs.N_USERS, cs.N_ITEMS))
        dtype_trace(dev, nu, ni,
                    int(args[3]) if len(args) > 3 else DTYPE_EPOCHS)
        sys.exit(0)
    dev = args[0] if args else "cuda:0"
    nu, ni = (int(args[1]), int(args[2])) if len(args) > 2 \
        else (cs.N_USERS, cs.N_ITEMS)
    if dev.startswith("cuda"):
        print("[device]", cs.gpu_line())
    if mode == "trace":
        trace(dev, nu, ni)
    else:
        for kind in ("coo", "blocked"):
            run(kind, dev, nu, ni)
