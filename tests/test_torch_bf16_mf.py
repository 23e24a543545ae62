"""bf16 MF (``--ns``, one id field per side): the port against the JAX
package at bf16 storage, AUC after each epoch.

On the card the port's bf16 MF at 200,000 x 20,000 (k=32) stays at AUC
0.50 over 11 epochs while float32 reaches 0.80 (chip_smoke ``[bf16 mf]``).
The tier-1 case trains both packages at bf16 (``refresh_every`` 10, the
bf16 default) from one JAX-written model on a small MF and holds their
AUCs within 0.02 of each other at every epoch;
``python tests/test_torch_bf16_mf.py [n_users n_items epochs seconds]``
runs the JAX package alone at bf16 on the CPU on chip_smoke's MF data
(200,000 x 20,000 by default), printing the AUC after each epoch until
the time box (1800 s) ends."""

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


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    import conftest  # noqa: F401  (JAX on the CPU)
    import chip_smoke as cs

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
        f"epoch {ep}: AUC {a:.4f} ({time.perf_counter() - t0:.0f} s)",
        flush=True))
