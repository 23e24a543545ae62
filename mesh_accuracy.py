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
"""
import os
import pickle
import sys

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


if __name__ == "__main__":
    dev = sys.argv[1] if len(sys.argv) > 1 else "cuda:0"
    nu, ni = (int(sys.argv[2]), int(sys.argv[3])) if len(sys.argv) > 3 \
        else (cs.N_USERS, cs.N_ITEMS)
    if dev.startswith("cuda"):
        print("[device]", cs.gpu_line())
    for kind in ("coo", "blocked"):
        run(kind, dev, nu, ni)
