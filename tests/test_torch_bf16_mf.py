"""bf16 MF (``--ns``, one id field per side): the port against the JAX
package at bf16 storage, AUC after each epoch.

On the card the port's bf16 MF at 200,000 x 20,000 (k=32) stays at AUC
0.50 over 11 epochs while float32 reaches 0.80 (chip_smoke ``[bf16 mf]``).
The tier-1 case trains both packages at bf16 (``refresh_every`` 10, the
bf16 default) from one JAX-written model on a small MF and holds their
AUCs within 0.02 of each other at every epoch;
``python tests/test_torch_bf16_mf.py [n_users n_items epochs seconds]``
runs the JAX package alone at bf16 on the CPU on chip_smoke's MF data
(200,000 x 20,000 by default), printing the AUC and the objective after
each epoch until the time box (1800 s) ends;
``python tests/test_torch_bf16_mf.py grad n_users n_items halves`` holds
the port's and the JAX package's bf16 gradients to float64 on the same
tables (``gradient_errors``)."""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_trainer(data, epochs: int, dtype: str = "bfloat16", k: int = 32,
                 init_model=None):
    from one_class_ffm_tpu.train import TrainConfig, Trainer

    cfg = TrainConfig(item_path="<memory>", train_path="<memory>", k=k,
                      lam=0.05, omega=0.1, r=-1.0, nr_pass=epochs,
                      self_side=False, dtype=dtype, eval_every=1, seed=0,
                      cg_precond="auto", init_model=init_model)
    return Trainer(cfg, data=data)


def aucs_per_epoch(trainer, epochs: int, deadline: float = float("inf"),
                   log=None):
    """Train ``epochs`` epochs one at a time; the AUC after each."""
    out = []
    trainer.init_state()
    for ep in range(1, epochs + 1):
        trainer.cfg = dataclasses.replace(trainer.cfg, nr_pass=ep)
        trainer.run(log=lambda *_: None)
        out.append(float(trainer.validate()["auc"]))
        if log:
            log(ep, out[-1])
        if time.perf_counter() > deadline:
            break
    return out


def test_port_bf16_mf_tracks_the_jax_package(tmp_path):
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from one_class_ffm_tpu import train as jax_train

    torch.set_num_threads(2)
    data = cs.build_data(3000, 600, 5.0, seed=0)
    init = _jax_trainer(data, 1, dtype="float32", k=8)
    init.init_state()
    model = str(tmp_path / "init.txt")
    jax_train.save_text_model(model, init.params_numpy(), data.layout, 8)
    ref = aucs_per_epoch(_jax_trainer(data, 4, k=8, init_model=model), 4)
    port = cs.make_trainer(data, torch.device("cpu"), k=8,
                           dtype="bfloat16", epochs=1,
                           init_model=model)
    got = aucs_per_epoch(port, 4)
    print(f"bf16 MF 3000 x 600, k=8, AUC per epoch: port {got}, JAX {ref}")
    assert max(got) > 0.6 and max(ref) > 0.6
    np.testing.assert_allclose(got, ref, atol=0.02)


def gradient_errors(nu: int, ni: int, halves: int):
    """The port steps bf16 MF ``halves`` half-solves from the seed; on the
    tables it reaches, the next half-solve's gradient is formed at bf16 by
    the port and by the JAX package (jitted, as in its epoch) and at
    float64 by the port, the caches of each re-derived from the same
    tables.  Prints each bf16 gradient's distance from float64,
    |d| / |G64| over the whole table."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs

    torch.set_num_threads(4)
    data = cs.build_data(nu, ni, 5.0, seed=0)
    cpu = torch.device("cpu")
    port = {dt: cs.make_trainer(data, cpu, dtype=dt, epochs=1)
            for dt in ("bfloat16", "float64")}
    solver = port["bfloat16"].solver
    state = port["bfloat16"].init_state()
    order = [(b, first) for b in solver.meta.layout.epoch_order()
             for first in (True, False)]
    for h in range(halves):
        if h % len(order) == 0:
            sa, sb = solver.sasb(state)
        b, first = order[h % len(order)]
        state, _ = solver._solve_half(state, b, first, sa, sb)
    b, first = order[halves % len(order)]
    tables = {f12: {n: t.float().numpy() for n, t in blk.items()}
              for f12, blk in state["params"].items()}
    grads = {}
    for dt, tr in port.items():
        st = tr.solver.refresh_caches({"params": {
            f12: {n: torch.from_numpy(t).to(tr.dtype)
                  for n, t in blk.items()} for f12, blk in tables.items()}})
        grads[f"port {dt}"] = tr.solver.solve_inputs(
            st, b, first, *tr.solver.sasb(st))[0].double()
    js = _jax_trainer(data, 1).solver
    jst = js.refresh_caches({"params": {
        f12: {n: jnp.asarray(t, jnp.bfloat16) for n, t in blk.items()}
        for f12, blk in tables.items()}})
    jb = next(x for x in js.meta.layout.epoch_order() if x.f12 == b.f12)
    gj = jax.jit(lambda st: js._grad_cross(st, jb, first))(jst)
    grads["JAX bfloat16"] = torch.from_numpy(
        np.asarray(gj, np.float64))[: grads["port float64"].shape[0]]
    ref = grads["port float64"]
    print(f"bf16 MF {nu} x {ni}, k=32: the gradient of half-solve {halves} "
          f"(table {'W' if first else 'H'}) on the port's bf16 tables; "
          f"|G64| {float(ref.norm()):.4e}")
    for name in ("port bfloat16", "JAX bfloat16"):
        print(f"{name}: |G - G64| / |G64| "
              f"{float((grads[name] - ref).norm() / ref.norm()):.4e}",
              flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the CPU)
    import chip_smoke as cs

    if sys.argv[1:2] == ["grad"]:
        gradient_errors(*(int(a) for a in sys.argv[2:5]))
        sys.exit(0)

    nu, ni, epochs, box = ((int(sys.argv[1]), int(sys.argv[2]),
                            int(sys.argv[3]), float(sys.argv[4]))
                           if len(sys.argv) > 4
                           else (cs.N_USERS, cs.N_ITEMS, 11, 1800.0))
    t0 = time.perf_counter()
    data = cs.build_data(nu, ni, 5.0, seed=0)
    tr = _jax_trainer(data, epochs)
    print(f"JAX package, bf16 MF --ns {nu} x {ni}, k=32, refresh_every "
          f"{tr.refresh_every}, CPU; set-up {time.perf_counter() - t0:.1f} s",
          flush=True)
    aucs_per_epoch(tr, epochs, deadline=t0 + box, log=lambda ep, a: print(
        f"epoch {ep}: AUC {a:.4f} objective "
        f"{float(tr.solver.objective(tr.state)):.6e} "
        f"({time.perf_counter() - t0:.0f} s)", flush=True))
