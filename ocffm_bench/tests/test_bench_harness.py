"""The harness is driven by data: cells, configurations, mixes, limits and
per-layer metrics are found by name, and adding one edits no file; and the
one-line result, rehearsed on the CPU through the harness's functions."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from ocffm_bench import harness, trace
from ocffm_bench.tests.common import tiny_context

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def bench():
    return harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_every_cell_resolves():
    b = bench()
    for w in b["workloads"]:
        _, _, ctx = harness.make_context(w["name"], 1, 1.0, False, "cpu",
                                         time.perf_counter())
        assert ctx.config["name"] == w["config"]
        assert os.path.exists(os.path.join(
            BENCH, "drivers", ctx.traffic["driver"] + ".py"))
        for m in harness.cell_metrics(b, w["name"], True):
            assert callable(harness.load_reader(m["name"]))


def test_every_metric_has_a_reader_and_a_cell():
    b = bench()
    names = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(BENCH, "metrics",
                                           m["name"] + ".py"))
        assert set(m["workloads"]) <= names
    for w in names:
        assert harness.cell_metrics(b, w, False)
        assert harness.cell_metrics(b, w, True)


def test_adding_a_cell_edits_no_file(tmp_path):
    """A copy of the benchmark with a new configuration, mix, metric and
    cell added as new files and entries: the harness finds them all, and
    every file already there is byte for byte the same."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "ocffm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = {p: open(os.path.join(d, p), "rb").read()
              for d, _, fs in os.walk(root) for p in fs}
    b = json.load(open(root / "BENCHMARK.json"))
    cfg = json.load(open(root / "ocffm_bench/configs/kkbox-mf-k32.json"))
    cfg.update(name="toy-mf-k16", k=16)
    json.dump(cfg, open(root / "ocffm_bench/configs/toy-mf-k16.json", "w"))
    tr = json.load(open(root / "ocffm_bench/traffic/train-uniform.json"))
    tr["epochs_per_job"] = 2
    json.dump(tr, open(root / "ocffm_bench/traffic/train-short.json", "w"))
    json.dump({"loss_gap": 1, "step1_gap": 1, "stepN_gap": 1},
              open(root / "ocffm_bench/limits/toy-mf-k16.train-short.json",
                   "w"))
    (root / "ocffm_bench/metrics/epochs.train.py").write_text(
        "def read(run):\n    return run.get('epochs')\n")
    b["configs"].append(dict(name="toy-mf-k16", source="x",
                             file="ocffm_bench/configs/toy-mf-k16.json",
                             reduced=[], why="x"))
    b["workloads"].append(dict(name="toy-mf-k16.train-short",
                               config="toy-mf-k16", traffic="train-short",
                               chips=1, why="x"))
    b["end_to_end"][0]["workloads"].append("toy-mf-k16.train-short")
    b["per_layer"].append(dict(name="epochs.train", unit="epochs",
                               better="higher", source="program_counter",
                               layer="epoch", moves="train_examples_per_s",
                               workloads=["toy-mf-k16.train-short"]))
    json.dump(b, open(root / "BENCHMARK.json", "w"))
    bench_dir = str(root / "ocffm_bench")
    b2, cell, ctx = harness.make_context(
        "toy-mf-k16.train-short", 1, 1.0, True, "cpu", time.perf_counter(),
        bench_dir=bench_dir)
    assert ctx.config["k"] == 16 and ctx.traffic["epochs_per_job"] == 2
    names = [m["name"] for m in harness.cell_metrics(b2, cell["name"], True)]
    assert names == ["epochs.train"]
    assert harness.load_reader("epochs.train", bench_dir)({"epochs": 4}) == 4
    after = {p: open(os.path.join(d, p), "rb").read()
             for d, _, fs in os.walk(root) for p in fs}
    changed = [p for p in before if p != "BENCHMARK.json"
               and after[p] != before[p]]
    assert changed == []


@pytest.mark.parametrize("workload", ["kkbox-mf-k32.train-uniform",
                                      "kkbox-ffm-k64.rank-b1024"])
@pytest.mark.parametrize("traced", [False, True])
def test_result_line(workload, traced):
    ctx = tiny_context(workload, traced=traced)
    res = harness.run_driver(ctx)
    line = harness.result_line(bench(), ctx, res)
    text = json.dumps(line)
    back = json.loads(text)
    assert list(back)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(back)[-1] == "checks"
    assert back["correct"] is True
    for c in back["checks"].values():
        assert set(c) == {"value", "limit"}
    if not traced:
        assert "setup_s" in back["metrics"]
    else:
        # the CPU has no device trace: no per-layer metric is made up
        assert back["metrics"] == {} and "busy_s" not in back["device"]
    assert back["device"]["platform"] == "cpu"


def test_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "kkbox-mf-k32.train-uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files has no
    program to run: the command fails and prints no result."""
    shutil.copytree(BENCH, tmp_path / "ocffm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "ocffm_bench/run.py", "--workload",
         "kkbox-mf-k32.train-uniform", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_spans_are_free_without_a_trace():
    assert isinstance(trace.Spans(False).span("x"),
                      type(__import__("contextlib").nullcontext()))
