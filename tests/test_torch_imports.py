"""The port never imports jax, and chip_smoke.py refuses to run without a
GPU; its in-memory data split and main-path loop run here on the CPU at
toy size."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def _run(code: str, cwd: str = ROOT) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_modules_import_without_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import one_class_ffm_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'one_class_ffm_torch.') if m.name != 'one_class_ffm_torch.__main__']\n"
        "for n in names: importlib.import_module(n)\n"
        "assert len(names) >= 10, names\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "print(len(names))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 10


# the JAX package's modules that the port and chip_smoke.py import: each
# must import without jax (the card's machine has none)
JAX_PACKAGE_MODULES = (
    "one_class_ffm_tpu.cli",
    "one_class_ffm_tpu.data.dataset",
    "one_class_ffm_tpu.data.synth",
    "one_class_ffm_tpu.evalx.numpy_metrics",
    "one_class_ffm_tpu.models.blocks",
    "one_class_ffm_tpu.solver.oracle",
    "one_class_ffm_tpu.solver.params",
    "one_class_ffm_tpu.train",
    "one_class_ffm_tpu.utils.profiling",
)


def test_jax_package_modules_the_port_uses_import_without_jax():
    """The listed modules import without jax, and the port and
    chip_smoke.py load nothing of the JAX package beyond what the listed
    modules themselves load."""
    code = (
        "import importlib, pkgutil, sys\n"
        "def tpu():\n"
        "    return {n for n in sys.modules\n"
        "            if n.startswith('one_class_ffm_tpu.')}\n"
        f"for n in {JAX_PACKAGE_MODULES!r}: importlib.import_module(n)\n"
        "listed = tpu()\n"
        "import one_class_ffm_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'one_class_ffm_torch.'):\n"
        "    if m.name != 'one_class_ffm_torch.__main__':\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "assert tpu() == listed, sorted(tpu() - listed)\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_fails_without_a_gpu_and_imports_no_jax():
    """Here torch.cuda.is_available() is False: exit 1, no result line,
    and nothing of jax imported on the way."""
    code = (
        "import runpy, sys\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert 'jax' not in sys.modules\n"
        "    sys.exit(e.code)\n")
    proc = _run(code)
    assert proc.returncode == 1
    assert '"ok"' not in proc.stdout
    assert "cuda.is_available() is False" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    (tmp_path / "chip_smoke.py").write_text(src)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_main_path_rehearsal_on_cpu():
    """The smoke script's in-memory MF split and main-path loop, at toy
    size with the plain versions."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    data = chip_smoke.build_data(600, 120, 5.0, seed=1)
    assert data.u_pad.m % 256 == 0 and data.v_pad.m % 256 == 0
    n_va = sum(len(x) for x in data.va_labels)
    assert data.nnz_true + n_va > data.nnz_true > 0
    # train and held-out positives are disjoint
    train = set(zip(data.y_pad.u[: data.nnz_true].tolist(),
                    data.y_pad.v[: data.nnz_true].tolist()))
    users = data.uva_pad.idx[0][: data.uva_pad.m_true, 0]
    for user, labs in zip(users, data.va_labels):
        assert not any((int(user), int(j)) in train for j in labs)
    trainer = chip_smoke.make_trainer(data, "cpu", k=4)
    res = chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.check_main_path(res)
    assert len(res["iters"]) == 3 and all(len(i) == 2 for i in res["iters"])
    assert res["metrics"]["auc"] > 0.5
    assert res["row"].startswith(" 3 (")
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.check_main_path(dict(res, objectives=[1.0, 2.0]))
    assert np.isfinite(res["objectives"]).all()


def test_chip_smoke_ffm_rehearsal_on_cpu():
    """The smoke script's FFM data (test users keep their feature rows),
    its recording of the table kernels' first calls and the FFM main-path
    loop, at toy size with the plain versions."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    data = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True)
    assert data.layout.fu == 2 and data.layout.self_side
    uva, u = data.uva_pad, data.u_pad
    users = uva.idx[0][: uva.m_true, 0]
    np.testing.assert_array_equal(uva.idx[1][: uva.m_true], u.idx[1][users])
    trainer = chip_smoke.make_trainer(data, "cpu", k=4)
    solver = trainer.solver
    state = trainer.init_state()
    names = {n for case in chip_smoke.ffm_cases(trainer) for n in case[0]}
    assert names == set(chip_smoke.TABLE)
    b = next(b for b in solver.blocks if b.kind == "uu" and b.f1 == 1)
    with chip_smoke.first_calls(chip_smoke.TABLE) as seen:
        solver._solve_half(state, b, True, *solver.sasb(state))
    assert seen == {}  # on the CPU the dispatchers take the plain versions
    res = chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.check_main_path(res)
    assert all(len(i) == 2 * len(solver.blocks) for i in res["iters"])
    assert res["metrics"]["auc"] > 0.5
