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


def test_jax_package_modules_the_port_uses_import_without_jax():
    """The port uses no module of the JAX package: importing every module
    of one_class_ffm_torch and chip_smoke.py loads no one_class_ffm_tpu
    module and no jax (the port keeps its own copies of the host code,
    tests/test_torch_copies.py)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import one_class_ffm_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    p.__path__, 'one_class_ffm_torch.')\n"
        "    if m.name != 'one_class_ffm_torch.__main__']\n"
        "for n in names: importlib.import_module(n)\n"
        "import chip_smoke\n"
        "tpu = sorted(n for n in sys.modules\n"
        "             if n.split('.')[0] == 'one_class_ffm_tpu')\n"
        "assert not tpu, tpu\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert len(names) >= 20, names\n"
        "for n in ('parallel', 'parallel.mesh', 'parallel.distributed',\n"
        "          'parallel.multihost', 'evalx.sharded_topk', 'prep',\n"
        "          'prep.split', 'prep.encode', 'prep.kdd12', 'prep.kkbox',\n"
        "          'prep.outbrain'):\n"
        "    assert 'one_class_ffm_torch.' + n in names, n\n")
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
    assert names == set(chip_smoke.TABLE) | {"project"}
    names = {n for case in chip_smoke.mesh_cases(trainer) for n in case[0]}
    assert names == set(chip_smoke.BLOCKED + chip_smoke.TABLE) | {"project"}
    b = next(b for b in solver.blocks if b.kind == "uu" and b.f1 == 1)
    with chip_smoke.first_calls(chip_smoke.TABLE) as seen:
        solver._solve_half(state, b, True, *solver.sasb(state))
    assert seen == {}  # on the CPU the dispatchers take the plain versions
    res = chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.check_main_path(res)
    assert all(len(i) == 2 * len(solver.blocks) for i in res["iters"])
    assert res["metrics"]["auc"] > 0.5


def test_chip_smoke_fm_rehearsal_on_cpu(tmp_path):
    """The smoke script's FM data (one flattened field per side, above a
    lowered cap), its FM cases, the FM main-path loop, its work counts and
    library yardsticks, and its FM text files, at toy size on the CPU."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    from one_class_ffm_torch import train

    data = chip_smoke.build_data(600, 120, 5.0, seed=2, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True, fm=True)
    assert data.u_pad.Ds == (630,) and data.v_pad.Ds == (140,)
    assert data.uva_pad.f == 1 and data.uva_pad.Ds == (630,)
    with chip_smoke.fused_cap(8):
        trainer = chip_smoke.make_trainer(data, "cpu", k=4)
    meta = trainer.solver.meta
    assert meta.fused_u == (False,) and meta.fused_v == (False,)
    assert meta.ident_u == (False,) and meta.ident_v == (False,)
    names = {n for case in chip_smoke.fm_cases(trainer) for n in case[0]}
    assert names == set(chip_smoke.BLOCKED + chip_smoke.WIDE)
    res = chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.check_main_path(res)
    assert all(len(i) == 6 for i in res["iters"])  # uv, uu, vv x 2 sides
    assert res["metrics"]["auc"] > 0.5

    # work and yardsticks of B8 and the scatter on a tiny field
    idx = torch.tensor([[0, 2, 2], [1, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[1.0, 0.5, 0.5], [2.0, 0.0, 0.0]])
    W = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    nbytes, ops = chip_smoke.work("project", (idx, val, W), torch.empty(2, 3))
    assert ops == 2 * 3 * 4  # four nonzero entries
    assert nbytes == 24 + 24 + 3 * 12 + 24  # idx, val, rows 0-2, out
    lib = chip_smoke.library_call("project", (idx, val, W))
    assert torch.equal(lib(), ops_mod().project_plain(idx, val, W))
    xt = trainer.solver.data["xf_u"][0]
    Z = torch.rand(xt.n_rows, 4)
    np.testing.assert_allclose(
        chip_smoke.library_call("scatter", (xt, Z))().numpy(),
        ops_mod().scatter_plain(xt, Z).numpy(), rtol=1e-5, atol=1e-6)
    # the blocked gradient scatter's sparse-product yardstick
    from one_class_ffm_torch.ops.layout import make_blocked_layout

    rng = np.random.default_rng(0)
    seg = np.sort(rng.integers(0, 32, size=90)).astype(np.int32)
    blk = make_blocked_layout(seg, seg, 32, 8, max_pad_ratio=50.0)
    own = torch.from_numpy(blk["own"])
    c = torch.from_numpy(rng.normal(size=own.shape).astype(np.float32))
    rows = torch.from_numpy(
        rng.normal(size=own.shape + (4,)).astype(np.float32))
    args = (c, rows, own, 32, 8)
    np.testing.assert_allclose(
        chip_smoke.library_call("pos_scatter_blocked", args)().numpy(),
        ops_mod().pos_scatter_blocked_plain(*args).numpy(), rtol=1e-5,
        atol=1e-6)
    assert chip_smoke.library_call("pos_gap_blocked", args) is None
    assert chip_smoke.bound_of(3.35e9, 0) == (1.0, "bytes")
    assert chip_smoke.bound_of(0, 67e9) == (1.0, "operations")

    chip_smoke.write_fm_dataset(str(tmp_path), chip_smoke_spec())
    loaded = train.load_problem(train.TrainConfig(
        item_path=str(tmp_path / "items.ffm"),
        train_path=str(tmp_path / "train.ffm"),
        test_path=str(tmp_path / "va.ffm")))
    assert loaded.layout.fu == 1 and loaded.layout.fv == 1
    assert loaded.u_pad.Ds == (90 + 50,) and loaded.v_pad.Ds == (30 + 30,)


def test_chip_smoke_serve_rehearsal_on_cpu(tmp_path, monkeypatch, capsys):
    """The smoke script's serving phase (files written from the padded
    rows, predict from the checkpoint, the project_plain route, the
    comparison with Trainer.predict_topk, the text model route and the
    timed split) on a toy FFM on the CPU, serve_bench through its knobs
    and the scoring entry point."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    data = chip_smoke.build_data(600, 120, 5.0, seed=1, dims_u=(600, 30),
                                 dims_v=(120, 20), self_side=True)
    trainer = chip_smoke.make_trainer(data, "cpu", k=4)
    chip_smoke.train_and_validate(trainer, epochs=3)
    chip_smoke.serve_phase(trainer, "cpu", "cpu", reps=2)
    out = capsys.readouterr().out
    assert "ids equal to the project_plain route's: True" in out
    assert out.count("users/s (") == 2 and "best of 2" in out
    items = (tmp_path / "serve_ffm" / "items.ffm").read_text().splitlines()
    assert len(items) == 120 and items[0].startswith("0:0:1.0 1:")
    for key, val in dict(SB_USERS=300, SB_ITEMS=50, SB_K=4, SB_CHUNK=64,
                         SB_REPS=1).items():
        monkeypatch.setenv(key, str(val))
    chip_smoke.serve_bench_phase(torch.device("cpu"), "cpu")
    chip_smoke.entry_phase("cpu", "cpu")
    out = capsys.readouterr().out
    assert '"metric": "serving_users_per_sec"' in out
    assert "[entry] scores (64, 32) on cpu, finite True" in out


def ops_mod():
    from one_class_ffm_torch.ops import sparse_ops

    return sparse_ops


def chip_smoke_spec():
    from one_class_ffm_torch.data.synth import SynthSpec

    return SynthSpec(n_users=90, n_items=30, avg_pos=5.0, seed=3)


def test_chip_smoke_prep_and_bf16_mf_rehearsal_on_cpu(tmp_path, monkeypatch,
                                                      capsys):
    """The smoke script's ``[prep]`` phase (the port's KKBox pipeline on
    tiny raw CSVs, one epoch on its output) and ``[bf16 mf]`` phase (bf16
    beside float32, AUC per epoch) on the CPU at toy size."""
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "BF16_EPOCHS", 2)
    chip_smoke.prep_phase(torch.device("cpu"), "cpu")
    mf = chip_smoke.build_data(600, 120, 5.0, seed=1)
    chip_smoke.bf16_mf_phase(mf, torch.device("cpu"), "cpu")
    out = capsys.readouterr().out
    assert "[prep] kkbox: raw CSVs -> ['listener.ffm'" in out
    assert (tmp_path / "prep_kkbox" / "out" / "top_song.ffm").exists()
    assert "[bf16 mf] epoch 2: AUC bf16 " in out
    assert "refresh_every 10" in out and "refresh_every 0" in out
