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
    data = chip_smoke.build_mf_data(600, 120, 5.0, seed=1)
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
