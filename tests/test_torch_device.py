"""The port's data-assembly entry points run on the card unless the caller
asks for the CPU: without a card, a call that names no device raises before
it builds any tensor."""

import numpy as np
import pytest
import torch

from one_class_ffm_torch.data.dataset import PaddedFields, PaddedLabels
from one_class_ffm_torch.evalx import torch_eval
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.solver import torch_solver
from one_class_ffm_torch.solver.convert import params_from_numpy
from one_class_ffm_torch.solver.params import HyperParams
from one_class_ffm_torch.train import resolve_device

torch.set_num_threads(1)


def _fields(m):
    return PaddedFields(m=m, m_true=m, f=1, Ds=(m,),
                        idx=(np.arange(m, dtype=np.int32)[:, None],),
                        val=(np.ones((m, 1)),), freq=(np.ones(m),),
                        row_nnz=np.ones(m, np.int32))


def _calls():
    """One call of each entry point, naming no device."""
    lay = BlockLayout.make((8,), (8,), False)
    u = v = _fields(8)
    y = PaddedLabels(nnz=8, nnz_true=8, u=np.arange(8, dtype=np.int32),
                     v=np.arange(8, dtype=np.int32), w=np.ones(8),
                     count_u=np.ones(8), count_v=np.ones(8))
    return {
        "make_device_data": lambda: torch_solver.make_device_data(
            u, v, y, lay, HyperParams(k=2), blocked_bm=4),
        "make_eval_data": lambda: torch_eval.make_eval_data(
            u, [np.array([1])] * 8, np.full(8, 1 / 8), n_items=8,
            n_items_true=8, layout=lay),
        "params_from_numpy": lambda: params_from_numpy(
            {0: {"W": np.zeros((8, 2)), "H": np.zeros((8, 2))}}),
    }


@pytest.mark.parametrize("name", ["make_device_data", "make_eval_data",
                                  "params_from_numpy"])
def test_entry_points_default_to_the_card(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_tensors(*args, **kw):
        raise AssertionError("a tensor was built before the device check")

    call = _calls()[name]
    monkeypatch.setattr(torch, "from_numpy", no_tensors)
    monkeypatch.setattr(torch, "as_tensor", no_tensors)
    with pytest.raises(RuntimeError, match="CUDA device was requested"):
        call()


def test_cpu_on_request():
    """device="cpu" builds CPU tensors, and the Trainer's resolver is the
    shared one."""
    calls = _calls()
    u = _fields(8)
    lay = BlockLayout.make((8,), (8,), False)
    _, data = torch_eval.make_eval_data(
        u, [np.array([1])] * 8, np.full(8, 1 / 8), n_items=8,
        n_items_true=8, layout=lay, device="cpu")
    assert data["labels"].device.type == "cpu"
    assert params_from_numpy({0: {"W": np.zeros((8, 2))}}, "cpu")[0][
        "W"].device.type == "cpu"
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported"):
        resolve_device("meta")
    assert set(calls) == {"make_device_data", "make_eval_data",
                          "params_from_numpy"}
