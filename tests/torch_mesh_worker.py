"""Rank functions of the port's multi-process tests (test_torch_sharding.py,
test_torch_sharded_topk.py, test_torch_multihost.py).

``one_class_ffm_torch.parallel.distributed.spawn`` starts each rank as a
fresh process that imports this module: it imports torch and the port
only, never jax or the JAX package.  The test process builds the host
arrays and the references and hands the arrays over; each function runs
several checks in one process group and returns plain numpy results."""

import torch

from one_class_ffm_torch.evalx.torch_eval import Evaluator, make_eval_data
from one_class_ffm_torch.parallel.mesh import make_mesh, shard_data
from one_class_ffm_torch.solver.convert import (
    params_from_numpy,
    params_to_numpy,
)
from one_class_ffm_torch.solver.torch_solver import (
    FFMSolver,
    make_device_data,
)

F64 = torch.float64


def mesh_epochs(problems, epochs: int = 1):
    """For each named problem (dict of host views u, v, y, layout, hp,
    params, block rows ``bm``; optional ``head_chunk``, a mesh spec
    ``mesh`` such as ``"2x2"``, ``model_min_rows`` and ``d_multiple``): the
    rank's solver on its part of the shard-aligned data, refreshed from the
    tables, ``epochs`` epochs.  Returns per problem the whole tables (padded
    dims), CG counts, objectives, this rank's side sums, carries and stream
    residual, the census of the epochs, the tables as the rank holds them
    and its part of the data's head and COO keys."""
    from one_class_ffm_torch.parallel.mesh import resolve_mesh

    torch.set_num_threads(1)
    meshes = {}
    out = {}
    for name, pb in problems.items():
        spec = pb.get("mesh", "auto")
        if spec not in meshes:  # every rank makes the groups in one order
            meshes[spec] = resolve_mesh(spec, device="cpu")
        mesh = meshes[spec]
        meta, data = make_device_data(
            pb["u"], pb["v"], pb["y"], pb["layout"], pb["hp"], dtype=F64,
            blocked_bm=pb["bm"], head_chunk=pb.get("head_chunk", 512),
            device="cpu", blocked_shards=mesh.size,
            d_multiple=pb.get("d_multiple", 1))
        solver = FFMSolver(meta, shard_data(data, mesh), mesh=mesh,
                           model_min_rows=pb.get("model_min_rows"))
        st = solver.refresh_caches(
            {"params": params_from_numpy(pb["params"], "cpu", F64)})
        obj = [float(solver.objective(st))]
        mesh.census.reset()
        iters = []
        for _ in range(epochs):
            st, it = solver.epoch_stats(st)
            iters.append(it.tolist())
        census = mesh.census.rows()
        obj.append(float(solver.objective(st)))
        d = solver.data
        out[name] = dict(
            params=params_to_numpy(solver.full_params(st["params"])),
            held=params_to_numpy(st["params"]), iters=iters, obj=obj,
            census=census, a=st["a"].numpy(), b=st["b"].numpy(),
            yt_u=st["yt_u"].numpy(), yt_stream=solver.yt_stream(st).numpy(),
            pos_u=d["pos_u"].numpy(), pos_v=d["pos_v"].numpy(),
            hd=(solver.hd_u, solver.hd_v),
            coo=tuple(solver._coo(s) is not None for s in (True, False)),
            hd_rows={s: d[f"blk_{s}_hd_rows"].numpy() for s in "uv"
                     if f"blk_{s}_hd_rows" in d},
            rows=(solver.m_l, solver.n_l, mesh.rank, mesh.size),
            model=(mesh.model_rank, mesh.n_model))
    return out


def sharded_eval(ev_in, by_list):
    """The evaluator's metrics sharded ``by`` users and items, from the
    full host test data and item side (``Q``, ``bt``: every item row; each
    rank passes its own rows)."""
    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    emeta, edata = make_eval_data(
        ev_in["uva"], ev_in["va_labels"], ev_in["popular"],
        n_items=ev_in["n"], n_items_true=ev_in["n_true"],
        layout=ev_in["layout"], dtype=F64, device="cpu")
    ev = Evaluator(emeta, edata, chunk=ev_in["chunk"])
    params = params_from_numpy(ev_in["params"], "cpu", F64)
    rows = mesh.rows(ev_in["n"])
    Q = {f12: torch.from_numpy(q[rows]) for f12, q in ev_in["Q"].items()}
    bt = torch.from_numpy(ev_in["bt"][rows])
    out = {}
    for by in by_list:
        sev = ev.shard(mesh) if by == "users" else ev.shard_items(mesh)
        mesh.census.reset()
        out[by] = dict(metrics=sev.validate(params, Q, bt),
                       census=mesh.census.rows())
    return out


def mesh_topk(cases):
    """``sharded_topk`` / ``make_sharded_topk_fn`` /
    ``topk_over_sharded_catalog`` on each case's full host arrays, this
    rank holding its slice of the items."""
    from one_class_ffm_torch.evalx.sharded_topk import (
        make_sharded_topk_fn,
        sharded_topk,
        topk_over_sharded_catalog,
    )

    torch.set_num_threads(1)
    mesh = make_mesh(device="cpu")
    out = {}
    for name, c in cases.items():
        rows = mesh.rows(c["bt"].shape[0])
        Pva = {f: torch.from_numpy(p) for f, p in c["Pva"].items()}
        Q = {f: torch.from_numpy(q[rows]) for f, q in c["Q"].items()}
        bt = torch.from_numpy(c["bt"][rows])
        if c["kind"] == "one_shot":
            vals, ids = topk_over_sharded_catalog(Pva, Q, bt, None, mesh,
                                                  c["k"])
        elif c["kind"] == "serving":
            fn = make_sharded_topk_fn(sorted(Q), mesh, c["k"],
                                      catalog=c["catalog"])
            vals, ids = fn(Pva, torch.from_numpy(c["cold"]), Q, bt,
                           torch.from_numpy(c["popular"][rows]))
        else:  # raw scores: each rank its columns
            z = torch.from_numpy(c["z"][:, rows])
            vals, ids = sharded_topk(lambda t: t, mesh, c["k"])(z)
        out[name] = (vals.numpy(), ids.numpy())
    return out


def trainer_run(kw, k_top, device="cpu"):
    """A Trainer of ``TrainConfig(**kw)`` run to its end on this rank:
    its log rows, metrics, tables, CG counts, top-``k_top`` ids and the
    shard of its state."""
    from one_class_ffm_torch.train import TrainConfig, Trainer

    torch.set_num_threads(1)
    tr = Trainer(TrainConfig(**kw), device=device)
    rows = []
    tr.run(log=rows.append)
    top = tr.predict_topk(k=k_top)
    return dict(rows=rows, metrics=tr.validate(), params=tr.params_numpy(),
                iters=[h["cg_iters"] for h in tr.history], top=top,
                shard_by=tr.evaluator.shard_by,
                a_rows=int(tr.state["a"].shape[0]), m=tr.meta.m,
                size=tr.mesh.size if tr.mesh is not None else 1,
                writer=tr.is_writer)


def fail_on(rank_to_fail):
    """Raise on one rank (the launcher must stop the others and report)."""
    import torch.distributed as dist

    if dist.get_rank() == rank_to_fail:
        raise RuntimeError(f"rank {rank_to_fail} fails on purpose")
    dist.barrier()
    return dist.get_rank()
