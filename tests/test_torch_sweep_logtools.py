"""The port's sweep runner and log tools: the JAX package's
``tests/test_sweep_logtools.py`` cases on ``one_class_ffm_torch.sweep`` and
``one_class_ffm_torch.logtools``, with one real tiny job through ``python
-m one_class_ffm_torch --platform cpu``."""

import os

from one_class_ffm_torch import logtools
from one_class_ffm_torch.sweep import (
    build_jobs,
    is_complete,
    log_path,
    omega_str,
    run_sweep,
    variant_name,
)

NEW_ROW = " 10 ( 5.07 , 13.4 ) ( 5.22 , 22 ) ( 3.81 , 28.1 ) ( 2.31 , 31.4 ) ( 1.25 , 32.8 ) 1.24"
OLD_ROW = "100 14.6 7.88 4.31 2.42 0.652"


def test_variant_and_omega_naming():
    assert variant_name("ffm", False) == "ffm-ffm"
    assert variant_name("mf", True) == "mf-mf--ns"
    assert omega_str(2.0**-5) == "0.03125"
    assert omega_str(1.0) == "1"
    assert omega_str(2.0**-11) == "0.00048828125"


def test_log_path_contract(tmp_path):
    p = log_path("logs", "kkbox", 64, True, "ffm-ffm--ns",
                 "/data/listener.trva.ffm", 4.0, 2.0**-5)
    # grid.sh contract: logs/<name>.<k>.te/<variant>/<stem>.<l>.<w>.<variant>
    assert p == "logs/kkbox.64.te/ffm-ffm--ns/listener.trva.ffm.4.0.03125.ffm-ffm--ns"


def make_spec(tmp_path, **kw):
    spec = dict(
        name="syn",
        log_root=str(tmp_path / "logs"),
        k=[2],
        lam=[1],
        epochs=4,
        eval_every=2,
        omega=[0.5],
        jobs=1,
        variants=[
            dict(model="mf", ns=True, item="items.ffm", train="tr.ffm", test="va.ffm")
        ],
    )
    spec["lambda"] = spec.pop("lam")
    spec.update(kw)
    return spec


def test_build_jobs_grid(tmp_path):
    spec = make_spec(tmp_path, k=[2, 4], omega=[0.5, 0.25])
    jobs = build_jobs(spec)
    assert len(jobs) == 4  # 2 k x 1 lambda x 2 omega
    cmd = " ".join(jobs[0].cmd)
    assert "--ns" in cmd and "-p va.ffm" in cmd and "-t 4" in cmd
    assert jobs[0].cmd[1:3] == ["-m", "one_class_ffm_torch"]


def test_is_complete(tmp_path):
    p = tmp_path / "log"
    p.write_text("iter header\n 2 ( 1 , 2 ) 0.5\n")
    assert not is_complete(str(p), 4, eval_every=2)
    p.write_text("iter header\n 2 ( 1 , 2 ) 0.5\n 4 ( 1 , 2 ) 0.5\n")
    assert is_complete(str(p), 4, eval_every=2)
    # epochs not a multiple of eval_every: last eval row is epoch 100
    p.write_text("100 ( 1 , 2 ) 0.5\n")
    assert is_complete(str(p), 105, eval_every=10)
    assert not is_complete(str(p), 110, eval_every=10)
    # the runner's .done marker always wins (covers no-test-set variants)
    q = tmp_path / "log2"
    q.write_text("")
    (tmp_path / "log2.done").write_text("ok\n")
    assert is_complete(str(q), 4, eval_every=2)


def test_sweep_dry_run_and_skip(tmp_path):
    spec = make_spec(tmp_path)
    jobs = build_jobs(spec)
    # mark the only job complete
    os.makedirs(os.path.dirname(jobs[0].log), exist_ok=True)
    with open(jobs[0].log, "w") as fh:
        fh.write(" 4 ( 1 , 2 ) 0.5\n")
    ran, skipped, failed = run_sweep(spec, dry_run=True, echo=lambda *_: None)
    assert (ran, skipped, failed) == (0, 1, 0)


def test_sweep_executes_real_job(tmp_path):
    """Run one real tiny training job of the port through the sweep
    runner."""
    from one_class_ffm_torch.data.synth import SynthSpec, write_dataset

    item, train, va = write_dataset(
        str(tmp_path), SynthSpec(n_users=40, n_items=12, avg_pos=4.0, seed=1)
    )
    spec = make_spec(
        tmp_path,
        variants=[dict(model="ffm", ns=False, item=item, train=train, test=va)],
        extra_args=["--dtype", "float64", "--eval-chunk", "32", "--platform", "cpu"],
        epochs=2,
        eval_every=2,
    )
    ran, skipped, failed = run_sweep(spec, echo=lambda *_: None)
    assert (ran, skipped, failed) == (1, 0, 0)
    jobs = build_jobs(spec)
    assert is_complete(jobs[0].log, 2)
    # resumable: second invocation skips
    ran, skipped, failed = run_sweep(spec, echo=lambda *_: None)
    assert (ran, skipped, failed) == (0, 1, 0)
    # logtools finds the row
    best = logtools.best_in_dir(os.path.dirname(jobs[0].log))
    assert "p@5" in best and "ploss" in best


def test_parse_new_and_old_row_formats():
    r = logtools.parse_row(NEW_ROW)
    assert r.epoch == 10
    assert r.p[5] == 5.07 and r.ndcg[10] == 22.0 and r.ploss == 1.24
    r = logtools.parse_row(OLD_ROW)
    assert r.epoch == 100
    assert r.p[5] == 14.6 and r.p[40] == 2.42
    assert logtools.parse_row("iter ( p@ 5, nDCG@5 ) ploss") is None


def test_logtools_sync_commits_to_local_repo(tmp_path):
    """`logtools sync` stages+commits the log dir; missing remote is benign.

    Replaces reference script/logs.tools/sync-log.sh (add/commit/pull/push).
    """
    import subprocess

    repo = tmp_path / "r"
    logs = repo / "logs"
    logs.mkdir(parents=True)
    (logs / "a.log").write_text("iter\n")

    def git(*a):
        subprocess.run(["git", "-C", str(repo), *a], check=True,
                       capture_output=True)

    git("init", "-q")
    git("config", "user.email", "t@t")
    git("config", "user.name", "t")
    git("commit", "-q", "--allow-empty", "-m", "root")

    out = []
    assert logtools.cmd_sync(str(logs), "track_logs", "origin",
                             echo=out.append) == 0
    log = subprocess.run(["git", "-C", str(repo), "log", "--oneline"],
                         capture_output=True, text=True).stdout
    assert "Update log" in log
    assert any("kept local" in line for line in out)  # no remote configured

    # clean tree: second sync is a no-op, not an error
    out2 = []
    assert logtools.cmd_sync(str(logs), "track_logs", "origin",
                             echo=out2.append) == 0
    assert any("nothing to commit" in line for line in out2)
