"""The float32 gradients' distance from their float64 value, the port's
against the JAX package's, on one state.

After an epoch a v-side gradient of the headline FFM is a small difference
of sums over every user (the per-row z, terms near n_users, and the dense
Gram terms), so at float32 it carries a rounding error that grows with the
row count.  ``gaps`` trains the port one epoch at float32 from the seed on
the CPU, then from those tables (caches refreshed in each solver) forms
every half-solve's gradient three ways: the port at float32, the JAX
package's ``FFMSolver`` at float32 (its XLA ops on the CPU), and the port
at float64 (the value: the port's float64 solver equals the JAX package's
at rtol 1e-9, ``test_torch_solver.py``).  The tier-1 case holds, at a small
size, the port's float32 gap within ten times the JAX package's on every
gradient; ``python tests/test_torch_f32_gap.py [n_users n_items]`` prints
the table at the headline's 200,000 x 20,000."""

import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max()) / (float(np.abs(b).max()) or 1.0)


def gaps(n_users: int, n_items: int):
    """Per half-solve (epoch order): (block, table, the port's float32 gap,
    the JAX package's float32 gap, max|G| at float64)."""
    import jax.numpy as jnp

    from one_class_ffm_tpu.models.blocks import BlockLayout as JaxLayout
    from one_class_ffm_tpu.solver import jax_solver
    from one_class_ffm_tpu.solver.params import HyperParams as JaxHyper

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from one_class_ffm_torch.solver.convert import params_from_numpy

    dims = dict(dims_u=(n_users, 1000), dims_v=(n_items, 500))
    data = cs.build_data(n_users, n_items, 5.0, seed=0, self_side=True,
                         **dims)
    cpu = torch.device("cpu")
    t32 = cs.make_trainer(data, cpu, epochs=1)
    state1, _ = t32.solver.epoch_stats(t32.init_state())
    tables = {f12: {n: t.double().numpy() for n, t in blk.items()}
              for f12, blk in t32.solver.full_params(
                  state1["params"]).items()}
    del state1
    t64 = cs.make_trainer(data, cpu, dtype="float64", epochs=1)
    ports = {}
    for tag, tr, dt in (("32", t32, torch.float32), ("64", t64,
                                                     torch.float64)):
        st = tr.solver.refresh_caches(
            {"params": params_from_numpy(tables, cpu, dt)})
        ports[tag] = (tr.solver, st, tr.solver.sasb(st))
    lay = data.layout
    jlay = JaxLayout.make(lay.Du, lay.Dv, lay.self_side)
    jhp = JaxHyper(**{f: getattr(t32.meta.hp, f) for f in (
        "k", "lam", "omega", "r", "nr_pass", "self_side", "freq",
        "cg_max_iter", "cg_eps", "cg_precond")})
    jmeta, jdata = jax_solver.make_device_data(
        data.u_pad, data.v_pad, data.y_pad, jlay, jhp, dtype=jnp.float32,
        blocked_bm=256)
    js = jax_solver.FFMSolver(jmeta, jdata)
    jst = js.refresh_caches({"params": {
        f12: {n: jnp.asarray(t, jnp.float32) for n, t in blk.items()}
        for f12, blk in tables.items()}})
    jsa, jsb = js._cache_sasb(jst["P"], jst["Q"])
    rows = []
    for b in lay.epoch_order():
        for first in (True, False):
            G = {}
            for tag, (solver, st, (sa, sb)) in ports.items():
                G[tag] = solver.solve_inputs(st, b, first, sa, sb)[0]
                G[tag] = G[tag].double().numpy()
            if b.kind == "uv":
                gj = js._grad_cross(jst, b, first)
            else:
                gj = js._grad_self(jst, b, first, jsa, jsb)
            gj = np.asarray(gj, np.float64)
            rows.append((b.f12, b.kind, "W" if first else "H",
                         _rel(G["32"], G["64"]), _rel(gj, G["64"]),
                         float(np.abs(G["64"]).max())))
    return rows


def report(rows, n_users, n_items):
    print(f"float32 gradient vs float64, one state after the port's first "
          f"float32 epoch, {n_users} x {n_items} (max|d|/max|G64|):")
    print("block kind table   port f32   JAX f32   max|G64|")
    for f12, kind, tbl, port, jax_gap, g in rows:
        print(f"{str(f12):>5s} {kind:4s} {tbl:5s} {port:.3e} {jax_gap:.3e} "
              f"{g:.4e}")
    v = [r for r in rows if r[2] == "H" or r[1] == "vv"]
    print(f"v side (the item tables): port {max(r[3] for r in v):.3e}, "
          f"JAX {max(r[4] for r in v):.3e}")


def test_port_float32_gradients_round_as_the_jax_package_does():
    torch.set_num_threads(2)
    rows = gaps(4096, 1024)
    report(rows, 4096, 1024)
    for f12, kind, tbl, port, jax_gap, _ in rows:
        assert port <= 10 * max(jax_gap, 1e-7), (f12, kind, tbl, port,
                                                 jax_gap)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import conftest  # noqa: F401  (JAX on the CPU, float64 on)

    nu, ni = ((int(sys.argv[1]), int(sys.argv[2])) if len(sys.argv) > 2
              else (200_000, 20_000))
    report(gaps(nu, ni), nu, ni)
