"""A data mesh's model against one process's where CG stops at its cap.

Under plain CG a solve stops when ||r||^2 <= cg_eps ||g||^2 or after
``cg_max_iter`` (20) iterations.  A mesh splits each sum over the rows into
per-rank parts, so it rounds otherwise than one process.  Unconverged CG
amplifies such rounding, the more the deeper it runs: at float64, with
every solve stopped at the cap, 4-6 iterations per solve keep the 2-rank
mesh's tables at one process's (rtol 1e-9, equal counts:
``test_capped_mesh_epochs_match_single_process``), while 20 iterations part
one process from itself by ~6e-3 after 2 epochs when its initial tables
move by 1e-15, and the mesh from one process by the same order
(``test_deep_capped_solves_part_one_process_from_itself``).  At float32
the parting is the reference's own: the JAX package's 2-device data mesh
(XLA host devices) parts from its one-device run by the same order as the
port's 2 ranks from its one process
(``test_float32_mesh_parts_as_the_jax_mesh_does``, which prints both
with ``-s``)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from one_class_ffm_torch.parallel.distributed import spawn
from one_class_ffm_torch.solver.convert import params_to_numpy

torch.set_num_threads(1)

EPOCHS = 2


def _rel(got, ref):
    """max over tables of max|d| / max|ref| (chip_smoke's model-file
    distance)."""
    return max(float(np.abs(got[f12][n] - blk[n]).max())
               / (float(np.abs(blk[n]).max()) or 1.0)
               for f12, blk in ref.items() for n in ("W", "H"))


def capped_problem(lam: float, cap: int, pert: float = 0.0):
    """A toy FFM (40 x 30 rows, fields of 40 / 12 and 30 / 10 features, self
    blocks, k=8: tables of 80-320 unknowns) under plain CG with cg_eps
    1e-20 and ``cg_max_iter`` ``cap``: every solve stops at the cap with
    its residual far above float64 rounding.  ``pert``: the initial W
    tables times (1 + pert * N(0, 1))."""
    from conftest import make_problem
    from one_class_ffm_torch.models.blocks import BlockLayout
    from one_class_ffm_torch.solver.params import HyperParams
    from test_torch_sharding import BM, host_views

    Du, Dv = (40, 12), (30, 10)
    prob, params = make_problem(np.random.default_rng(2), m=40, n=30,
                                Du=Du, Dv=Dv, k=8, lam=lam,
                                cg_precond="none")
    u, v, y = host_views(prob, 2)
    hp = dataclasses.replace(HyperParams(**dataclasses.asdict(prob.hp)),
                             cg_eps=1e-20, cg_max_iter=cap)
    rng = np.random.default_rng(9)
    tables = {f12: {"W": params["W"][f12]
                    * (1 + pert * rng.standard_normal(params["W"][f12].shape)),
                    "H": params["H"][f12]} for f12 in params["W"]}
    return dict(u=u, v=v, y=y, layout=BlockLayout.make(Du, Dv, True), hp=hp,
                params=tables, bm=BM)


def _one_process(pb):
    from test_torch_sharding import single_process

    _, state, iters, obj = single_process(pb, epochs=EPOCHS)
    return params_to_numpy(state["params"]), iters, obj


# (lambda, cap): 4 or 6 iterations of unconverged CG per solve, a depth at
# which one process's own tables move by at most 1e-11 when its initial
# tables move by 1e-15 (lambda 0.05: 5e-13, lambda 1: 4e-12)
@pytest.mark.parametrize("lam,cap", [(0.05, 4), (1.0, 6)])
def test_capped_mesh_epochs_match_single_process(tmp_path, lam, cap):
    """At float64, with every solve of 2 epochs stopped at the cap, the
    2-rank mesh's tables are one process's at rtol 1e-9 with equal CG
    counts: the cap itself parts nothing."""
    pb = capped_problem(lam, cap)
    ref, ref_iters, ref_obj = _one_process(pb)
    assert all(it == cap for ep in ref_iters for it in ep), ref_iters
    out = spawn("torch_mesh_worker:mesh_epochs", 2,
                args=({"capped": pb}, EPOCHS), workdir=str(tmp_path))
    for rank_out in out:
        got = rank_out["capped"]
        assert got["iters"] == ref_iters
        for f12, blk in ref.items():
            for name in ("W", "H"):
                np.testing.assert_allclose(
                    got["params"][f12][name], blk[name], rtol=1e-9,
                    atol=1e-11, err_msg=f"{name}[{f12}]")
        np.testing.assert_allclose(got["obj"], ref_obj, rtol=1e-9)


def test_deep_capped_solves_part_one_process_from_itself(tmp_path):
    """At float64 with every solve stopped at the default cap of 20 and
    lambda 0.05, unconverged CG amplifies rounding: initial tables moved
    by 1e-15 part one process's tables from its own by more than 1e-6
    after 2 epochs, and the 2-rank mesh, which rounds its row sums
    otherwise, parts from one process by the same order (within 100x).
    The mesh's parting at the cap is this amplification, not a fault."""
    ref, ref_iters, _ = _one_process(capped_problem(0.05, 20))
    assert all(it == 20 for ep in ref_iters for it in ep), ref_iters
    moved, _, _ = _one_process(capped_problem(0.05, 20, pert=1e-15))
    own = _rel(moved, ref)
    out = spawn("torch_mesh_worker:mesh_epochs", 2,
                args=({"capped": capped_problem(0.05, 20)}, EPOCHS),
                workdir=str(tmp_path))
    mesh = max(_rel(o["capped"]["params"], ref) for o in out)
    print(f"float64, every solve at the cap of 20: one process moved by "
          f"1e-15 parts from itself by {own:.3e}, the 2-rank mesh from one "
          f"process by {mesh:.3e}")
    assert own > 1e-6 and mesh > 1e-6
    assert own / 100 <= mesh <= 100 * own


def float32_distances(workdir: str, n_users: int, n_items: int):
    """Write a headline-shaped FFM (an id field and a 1000- / 500-feature
    field per side), train it 2 epochs at float32 (k=32, lam 0.05, omega
    0.1, plain CG): the JAX Trainer on one XLA host device and on a data
    mesh of 2, the port's Trainer in one process and on 2 gloo ranks.
    Returns each package's mesh-vs-one distance, the port's one process
    against the JAX one device, and the CG counts of the runs."""
    from one_class_ffm_tpu import train as jax_train
    from one_class_ffm_torch import train as torch_train
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    item, train, va = write_dataset(workdir, SynthSpec(
        n_users=n_users, n_items=n_items, avg_pos=5.0, seed=3,
        dims_u=(n_users, 1000), dims_v=(n_items, 500)))
    kw = dict(item_path=item, train_path=train, test_path=va, k=32,
              lam=0.05, omega=0.1, nr_pass=EPOCHS, eval_every=EPOCHS,
              dtype="float32", cg_precond="none")

    def jax_run(**extra):
        tr = jax_train.Trainer(jax_train.TrainConfig(**kw, **extra))
        tr.init_state()
        iters = []
        for _ in range(EPOCHS):
            tr.state, it = tr.solver.epoch_stats(tr.state)
            iters.append(np.asarray(it).tolist())
        return tr, iters

    j_one, j_one_it = jax_run()
    j_mesh, j_mesh_it = jax_run(mesh_shape="2")
    # both packages from the JAX one device's seeded tables
    model = os.path.join(workdir, "init.txt")
    init = jax_train.Trainer(jax_train.TrainConfig(**kw))
    init.init_state()
    jax_train.save_text_model(model, init.params_numpy(), init.data.layout,
                              32)
    t_one = torch_train.Trainer(torch_train.TrainConfig(
        **kw, init_model=model), device="cpu")
    t_one.run(log=lambda *_: None)
    t_mesh = spawn("torch_mesh_worker:trainer_run", 2,
                   args=(dict(kw, init_model=model, mesh_shape="2",
                              distributed=True), 1),
                   workdir=os.path.join(workdir, "ranks"))
    j_ref = jax_train.Trainer(jax_train.TrainConfig(**kw, init_model=model))
    j_ref.init_state()
    j_ref.run(log=lambda *_: None)
    t_one_p = t_one.params_numpy()
    return dict(
        jax_mesh_vs_one=_rel(j_mesh.params_numpy(), j_one.params_numpy()),
        port_mesh_vs_one=max(_rel(o["params"], t_one_p) for o in t_mesh),
        port_vs_jax_one=_rel(t_one_p, j_ref.params_numpy()),
        jax_iters=(j_one_it, j_mesh_it),
        port_iters=([h["cg_iters"] for h in t_one.history],
                    t_mesh[0]["iters"]),
        cap=20)


def _report(d):
    capped = sum(it == d["cap"] for ep in d["port_iters"][0] for it in ep)
    total = sum(len(ep) for ep in d["port_iters"][0])
    print(f"float32, {EPOCHS} epochs, max|d|/max|ref| over the tables: JAX "
          f"2-device mesh vs one device {d['jax_mesh_vs_one']:.3e}; port 2 "
          f"ranks vs one process {d['port_mesh_vs_one']:.3e}; port one "
          f"process vs JAX one device (same init) "
          f"{d['port_vs_jax_one']:.3e}; port solves at the cap {capped} of "
          f"{total}; CG counts JAX one / mesh {d['jax_iters']}, port one / "
          f"mesh {d['port_iters']}")


def test_float32_mesh_parts_as_the_jax_mesh_does(tmp_path):
    d = float32_distances(str(tmp_path), 2048, 1024)
    _report(d)
    assert any(it == d["cap"] for ep in d["port_iters"][0] for it in ep)
    # the same order: neither package's mesh keeps its one run's bits, and
    # the port's mesh parts no further than ten times the JAX mesh does
    assert d["jax_mesh_vs_one"] > 0 and d["port_mesh_vs_one"] > 0
    assert d["port_mesh_vs_one"] <= 10 * d["jax_mesh_vs_one"]

