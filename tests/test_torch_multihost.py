"""Multi-process runs of the port: ``init_distributed`` from torchrun's
environment, the placement helpers, the Trainer and the command line on a
data mesh of gloo ranks, ``dryrun_multichip`` (mirrors
``tests/test_multihost.py`` and ``tests/test_train_e2e.py:212-320``).

Ranks are processes that import torch and the port only; the references
(the port on one process, the JAX package) run in the test process."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from one_class_ffm_torch.parallel import distributed
from one_class_ffm_torch.parallel.distributed import (
    init_distributed,
    process_local_slice,
    spawn,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")

torch.set_num_threads(1)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _torchrun(argv_code, n: int, timeout: int = 300):
    """Start ``n`` processes as ``torchrun --nproc-per-node n`` would
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR / MASTER_PORT on
    localhost); returns their (returncode, stdout, stderr)."""
    port = _free_port()
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([REPO, TESTS]),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, *argv_code], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


SPEC = ("SynthSpec(n_users=64, n_items=32, avg_pos=4.0, seed=7, "
        "dims_u=(64, 16), dims_v=(32, 12))")
BUILD = f"""
import numpy as np, torch
from one_class_ffm_torch.data.synth import SynthSpec, build_padded
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.solver.params import HyperParams
from one_class_ffm_torch.solver.torch_solver import FFMSolver, make_device_data
torch.set_num_threads(1)
def build(shards, bm=4):
    (du, dv), u, v, y = build_padded({SPEC}, dtype=np.float64,
        row_multiple=4 * shards, shard_rows=64 // shards if shards > 1 else 0)
    lay = BlockLayout.make(du, dv, self_side=True)
    hp = HyperParams(k=4, lam=0.05, omega=0.1, cg_precond="none")
    return make_device_data(u, v, y, lay, hp, dtype=torch.float64,
        blocked_bm=bm, device="cpu", blocked_shards=shards)
def fingerprint(params):
    return sum(float(t.sum()) for blk in params.values() for t in blk.values())
"""

WORKER = BUILD + """
import sys
from one_class_ffm_torch.parallel.distributed import init_distributed
from one_class_ffm_torch.parallel.mesh import make_mesh, shard_data
from one_class_ffm_torch.parallel.multihost import (make_global,
    make_global_data, make_global_state)
mode, expected = sys.argv[1], float(sys.argv[2])
assert init_distributed(backend="gloo")  # torchrun's environment
mesh = make_mesh(device="cpu")
assert mesh.size == 4 // 2 * 1 or mesh.size == 2
meta, data = build(1)
# the full host state of the same tables, every process the same
solver1 = FFMSolver(meta, data)
st = solver1.init(torch.Generator().manual_seed(0))
if mode == "blk":
    meta_s, data_s = build(mesh.size)
    solver = FFMSolver(meta_s, make_global_data(data_s, mesh), mesh=mesh)
    gstate = make_global_state(st, mesh)
    assert gstate["a"].shape[0] == meta_s.m // mesh.size
    assert torch.equal(make_global(st["a"], mesh), gstate["a"])
    out = solver.epoch(gstate)
    fp = fingerprint(out["params"])
    print(f"fingerprint={fp!r} expected={expected!r}", flush=True)
    assert abs(fp - expected) <= 1e-9 * max(1.0, abs(expected)), (fp, expected)
else:
    try:
        if mode == "tp":  # tables row-sharded across the processes
            make_global_state(st, mesh, model_min_rows=8)
        else:  # "dp": the flat layout under a mesh (JAX's GSPMD fallback)
            FFMSolver(meta, data, mesh=mesh)
    except NotImplementedError as e:
        assert "ROADMAP A11b" in str(e), e
    else:
        raise AssertionError(f"{mode} did not raise")
print("MULTIHOST_OK", flush=True)
"""


def _single_process_fingerprint() -> float:
    ns = {}
    exec(BUILD, ns)
    meta, data = ns["build"](1)
    solver = ns["FFMSolver"](meta, data)
    out = solver.epoch(solver.init(torch.Generator().manual_seed(0)))
    return ns["fingerprint"](out["params"])


@pytest.mark.parametrize("mode", ["dp", "tp", "blk"])
def test_two_process_distributed_epoch(mode):
    """blk: two processes joined through torchrun's environment run the
    shard-aligned epoch, each on its half of the rows, from the same
    tables as one process: the same tables.  dp (the flat layout under a
    mesh) and tp (tables row-sharded on a model axis across the processes)
    wait for ROADMAP A11b and raise naming it."""
    expected = _single_process_fingerprint()
    outs = _torchrun(["-c", WORKER, mode, repr(expected)], 2)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"worker {i} failed:\n{out[-2000:]}\n{err[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-2000:]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    d = tmp_path_factory.mktemp("mh_data")
    return write_dataset(str(d), SynthSpec(n_users=150, n_items=50,
                                           avg_pos=6.0, seed=7))


def _cfg(dataset, **kw):
    item, train, va = dataset
    base = dict(item_path=item, train_path=train, test_path=va, k=4,
                nr_pass=3, eval_every=3, dtype="float64", blocked_bm=8,
                eval_chunk=16)
    base.update(kw)
    return base


@pytest.mark.parametrize("eval_shard", ["users", "items"])
def test_trainer_mesh_matches_single_device(dataset, tmp_path, eval_shard):
    """The product surface on a 2-rank data mesh: the Trainer's log rows,
    metrics, tables, CG counts and top-7 ids equal the single-device
    Trainer's (evaluation and top-K sharded by users, or by items with the
    ranks' candidates merged); the state lives half on each rank."""
    sys.path.insert(0, TESTS)
    import torch_mesh_worker

    ref = torch_mesh_worker.trainer_run(_cfg(dataset, row_multiple=16), 7)
    outs = spawn("torch_mesh_worker:trainer_run", 2,
                 args=(_cfg(dataset, mesh_shape="2", distributed=True,
                            eval_shard=eval_shard), 7),
                 workdir=str(tmp_path))
    for r, got in enumerate(outs):
        assert got["size"] == 2 and got["shard_by"] == eval_shard
        assert got["a_rows"] == got["m"] // 2
        assert got["writer"] == (r == 0)
        assert got["rows"] == ref["rows"]
        assert got["iters"] == ref["iters"]
        for key, val in ref["metrics"].items():
            np.testing.assert_allclose(got["metrics"][key], val, rtol=1e-9,
                                       err_msg=key)
        for f12, blk in ref["params"].items():
            for name in ("W", "H"):
                np.testing.assert_allclose(got["params"][f12][name],
                                           blk[name], rtol=1e-9, atol=1e-11)
        np.testing.assert_array_equal(got["top"], ref["top"])


def test_cli_mesh_under_torchrun_environment(dataset, tmp_path, capsys):
    """``python -m one_class_ffm_torch ... --mesh 2 --distributed`` started
    as torchrun starts it: rank 0 prints the single-process run's rows and
    writes the model, rank 1 prints nothing."""
    from one_class_ffm_torch import cli

    item, train, va = dataset
    argv = [item, train, "-p", va, "-k", "4", "-t", "2", "--eval-every",
            "2", "--platform", "cpu", "--dtype", "float64", "--blocked-bm",
            "8", "--eval-chunk", "16", "--predict-topk", "3"]
    assert cli.main(argv) == 0
    ref = capsys.readouterr().out
    model = str(tmp_path / "mesh_model.txt")
    outs = _torchrun(["-m", "one_class_ffm_torch", *argv, "--mesh", "2",
                      "--distributed", "-o", model], 2)
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"rank {i} failed:\n{err[-3000:]}"
    assert outs[0][1] == ref
    assert outs[1][1] == ""
    from one_class_ffm_torch.train import load_text_model

    _, k, _ = load_text_model(model)
    assert k == 4


def test_dryrun_multichip_on_two_cpu_ranks():
    """The counterpart of ``__graft_entry__.dryrun_multichip``: one sharded
    epoch, a sharded evaluation and an item-sharded top-5 through the
    Trainer on 2 spawned gloo ranks."""
    from one_class_ffm_torch.entry import dryrun_multichip

    outs = dryrun_multichip(2, device="cpu")
    assert [o["rank"] for o in outs] == [0, 1]
    assert outs[0]["objective"] == outs[1]["objective"]
    assert outs[0]["top_shape"][1] == 5


def test_spawn_stops_the_ranks_and_reports_a_failing_one(tmp_path):
    sys.path.insert(0, TESTS)
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn("torch_mesh_worker:fail_on", 2, args=(1,),
              workdir=str(tmp_path), timeout=120)


def test_init_distributed_without_environment_is_single_process(
        monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    assert init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert process_local_slice(12) == slice(0, 12)
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert init_distributed() is False


def test_init_distributed_names_the_fix(monkeypatch, tmp_path):
    """NCCL runs a rank per card: more ranks than cards on a host is an
    error naming the launch and the gloo alternative, never a silent
    switch; NCCL without a card is an error; a group without a rendezvous
    names the variables."""
    rdzv = f"file://{tmp_path / 'rdzv'}"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="nccl"):
        init_distributed(backend="nccl", init_method=rdzv, rank=0,
                         world_size=2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="nproc-per-node 1.*gloo"):
        init_distributed(backend="nccl", init_method=rdzv, rank=0,
                         world_size=2)
    for key in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        init_distributed(backend="gloo", rank=0, world_size=2)
    assert not torch.distributed.is_initialized()
    assert distributed.rank_device("gloo") == torch.device("cpu")


def test_chip_smoke_mesh_phase_rehearsed_on_the_cpu(tmp_path, monkeypatch,
                                                    capsys):
    """chip_smoke's ``[mesh ffm]`` at toy size on the CPU (the plain
    versions in place of the kernels): the single-process reference, the
    two spawned ranks, every check but the kernels' (their launches, and
    ``mesh_cases``' comparison with the plain versions)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "WORK", str(tmp_path))
    monkeypatch.setattr(chip_smoke, "MESH_CHECK_USERS", 200)
    spec = dict(n_users=600, n_items=300, rows=512,
                dims=dict(dims_u=(600, 12), dims_v=(300, 8)))
    report = chip_smoke.new_report()
    got = chip_smoke.mesh_phase(torch.device("cpu"), "cpu", report, spec)
    assert not any(got.values())  # no kernel launches on the CPU
    assert not any(r["max_abs_err"] for r in report.values())
    out = capsys.readouterr().out
    assert out.count("[mesh ffm] rank 1 epoch 3") == 2  # timing, census
    assert "validation by items" in out
