"""The port's scoring entry point against ``__graft_entry__.entry()``.

The JAX entry's example arguments cross to the port as numpy arrays
(tables through ``convert.params_from_numpy``); the port's step must give
the JAX step's scores within 1e-5 max-rel (float32).  The port's own
``entry()`` builds its example arguments by its own data assembly and
solver init, on the CPU when asked, at the JAX entry's shapes."""

import os
import sys

import numpy as np
import pytest
import torch

from one_class_ffm_torch import entry as torch_entry
from one_class_ffm_torch.solver.convert import params_from_numpy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_entry():
    """(example arguments, scores) of the JAX entry."""
    import jax

    sys.path.insert(0, ROOT)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(ROOT)
    fn, args = __graft_entry__.entry()
    return args, np.asarray(jax.jit(fn)(*args))


def test_step_matches_the_jax_entry(jax_entry):
    j_args, want = jax_entry
    params, xu_idx, xu_val, Q, bt = j_args

    def host(a):
        return torch.from_numpy(np.array(a))

    args = (params_from_numpy({f12: {n: np.asarray(t) for n, t in blk.items()}
                               for f12, blk in params.items()}, "cpu"),
            tuple(host(a) for a in xu_idx), tuple(host(a) for a in xu_val),
            {f12: host(q) for f12, q in Q.items()}, host(bt))
    fn, _ = torch_entry.entry("cpu")
    got = fn(*args).numpy()
    assert got.shape == want.shape == (64, 32)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_own_entry_runs_on_the_cpu_at_the_jax_shapes(jax_entry):
    (params, xu_idx, xu_val, Q, bt), want = jax_entry
    fn, own_args = torch_entry.entry("cpu")
    z = fn(*own_args)
    assert z.shape == want.shape and z.dtype == torch.float32
    assert torch.isfinite(z).all() and z.abs().max() > 0
    o_params, o_idx, o_val, o_Q, o_bt = own_args
    assert sorted(o_params) == sorted(int(f) for f in params)
    for f12, blk in o_params.items():
        for name, t in blk.items():
            assert tuple(t.shape) == np.shape(params[f12][name])
    assert [tuple(a.shape) for a in o_idx] == [np.shape(a) for a in xu_idx]
    assert [tuple(a.shape) for a in o_val] == [np.shape(a) for a in xu_val]
    assert {f: tuple(q.shape) for f, q in o_Q.items()} == {
        int(f): np.shape(q) for f, q in Q.items()}
    assert tuple(o_bt.shape) == np.shape(bt)
    assert all(a.device.type == "cpu" for a in (*o_idx, *o_val, o_bt))
