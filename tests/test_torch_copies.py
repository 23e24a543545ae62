"""The port's copies of the JAX package's framework-free host code.

The port imports nothing of the JAX package, so it keeps its own copy of
each host module it needs (data pipeline, synthetic data, block layout,
hyperparameters, fp64 oracle, numpy metrics, phase timer) and of the host
parts of ``train.py`` and ``cli.py``.  These tests hold every copy to its
original: the same syntax tree (comments and the module docstring aside)
and the same results on the conftest problems and on small written
datasets."""

import ast
import dataclasses
import importlib
import json
import os
import zipfile

import numpy as np
import pytest

from conftest import make_problem
from one_class_ffm_tpu import cli as jax_cli
from one_class_ffm_tpu import train as jax_train
from one_class_ffm_tpu.data import synth as jax_synth
from one_class_ffm_tpu.evalx import numpy_metrics as jax_metrics
from one_class_ffm_tpu.solver import oracle as jax_oracle
from one_class_ffm_tpu.utils import profiling as jax_profiling
from one_class_ffm_torch import cli as torch_cli
from one_class_ffm_torch import train as torch_train
from one_class_ffm_torch.data import synth as torch_synth
from one_class_ffm_torch.evalx import numpy_metrics as torch_metrics
from one_class_ffm_torch.models.blocks import BlockLayout
from one_class_ffm_torch.solver import oracle as torch_oracle
from one_class_ffm_torch.solver.params import HyperParams
from one_class_ffm_torch.utils import profiling as torch_profiling

COPIED_MODULES = ("data", "data.dataset", "data.io", "data.native_io",
                  "data.synth", "models.blocks", "solver.params",
                  "solver.oracle", "evalx.numpy_metrics", "logtools",
                  "prep", "prep.split", "prep.encode", "prep.kdd12",
                  "prep.kkbox", "prep.outbrain")


def _tree(path: str) -> ast.Module:
    with open(path) as fh:
        return ast.parse(fh.read())


def _body_dump(tree: ast.Module) -> str:
    """The module's syntax tree without its docstring."""
    body = tree.body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)
            and isinstance(body[0].value.value, str)):
        body = body[1:]
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def _defs(path: str):
    """Top-level functions and classes by name, and the methods of each
    class as "Class.method"."""
    out = {}
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef):
                        out[f"{node.name}.{sub.name}"] = sub
    return out


@pytest.mark.parametrize("name", COPIED_MODULES)
def test_copied_module_has_the_original_syntax_tree(name):
    orig = importlib.import_module(f"one_class_ffm_tpu.{name}")
    copy = importlib.import_module(f"one_class_ffm_torch.{name}")
    assert _body_dump(_tree(copy.__file__)) == _body_dump(
        _tree(orig.__file__))


def test_sweep_has_the_original_syntax_tree_but_the_module_it_runs():
    """The port's sweep runner is the JAX package's, its jobs running
    ``python -m one_class_ffm_torch`` (the one string constant swapped)."""
    from one_class_ffm_torch import sweep as torch_sweep
    from one_class_ffm_tpu import sweep as jax_sweep

    copy = _body_dump(_tree(torch_sweep.__file__))
    assert copy.count("'one_class_ffm_torch'") == 1
    assert copy.replace("'one_class_ffm_torch'", "'one_class_ffm_tpu'") == (
        _body_dump(_tree(jax_sweep.__file__)))


# (module, names) of the definitions the port copied into train.py, cli.py
# and utils/profiling.py
COPIED_DEFS = (
    ("train", ("TrainConfig", "NonFiniteMetricError", "LoadedData",
               "load_problem", "_lcm", "_rebuild_indptr", "save_text_model",
               "_fmt_g", "load_text_model", "save_checkpoint",
               "has_checkpoint", "load_checkpoint", "Trainer.describe",
               "Trainer._print_header", "Trainer._format_row",
               "Trainer._write_jsonl")),
    ("cli", ("config_from_args",)),
    ("utils.profiling", ("PhaseTimer",)),
)


@pytest.mark.parametrize("module, names", COPIED_DEFS,
                         ids=[m for m, _ in COPIED_DEFS])
def test_copied_definitions_have_the_original_syntax_trees(module, names):
    orig = _defs(importlib.import_module(f"one_class_ffm_tpu.{module}")
                 .__file__)
    copy = _defs(importlib.import_module(f"one_class_ffm_torch.{module}")
                 .__file__)
    for name in names:
        assert ast.dump(copy[name]) == ast.dump(orig[name]), name
    assert torch_train.TOP_KS == jax_train.TOP_KS


def _assert_same(a, b, path="data"):
    """Field by field: numpy arrays equal in value and dtype, containers
    recursively, everything else by ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _assert_same(a[key], b[key], f"{path}[{key!r}]")
    else:
        assert a == b, path


def _flatten(rows, dims):
    """All of a row's features in one field with offset ids (the FM
    encoding, as scripts/parity_check.py flattens the synthetic rows)."""
    offs = np.concatenate([[0], np.cumsum(dims)[:-1]])
    return [(labels, [(0, int(offs[f]) + i, v) for f, i, v in feats])
            for labels, feats in rows]


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Small written datasets: FFM (2+2 fields), FM (one flattened field
    per side) and MF (one id field per side)."""
    out = {}
    for tag, spec in (
            ("ffm", jax_synth.SynthSpec(n_users=70, n_items=25, avg_pos=4.0,
                                        seed=2)),
            ("mf", jax_synth.SynthSpec(n_users=60, n_items=20, fu=1, fv=1,
                                       avg_pos=4.0, seed=3))):
        d = tmp_path_factory.mktemp(tag)
        out[tag] = jax_synth.write_dataset(str(d), spec)
    spec = jax_synth.SynthSpec(n_users=70, n_items=25, avg_pos=4.0, seed=4)
    users, items = jax_synth.generate(spec)
    du, dv = spec.resolve()
    d = tmp_path_factory.mktemp("fm")
    paths = [str(d / name) for name in ("items.fm", "train.fm", "va.fm")]
    users = _flatten(users, du)
    jax_synth._write_rows(paths[0], _flatten(items, dv), with_labels=False)
    jax_synth._write_rows(paths[1], users, with_labels=True)
    jax_synth._write_rows(paths[2], [(lab[:1], f) for lab, f in users],
                          with_labels=True)
    out["fm"] = tuple(paths)
    return out


@pytest.mark.parametrize("tag", ["ffm", "fm", "mf"])
@pytest.mark.parametrize("row_multiple", [8, 256])
def test_load_problem_matches(datasets, tag, row_multiple):
    item, train, va = datasets[tag]
    kw = dict(item_path=item, train_path=train, test_path=va,
              row_multiple=row_multiple, self_side=tag != "mf")
    got = torch_train.load_problem(torch_train.TrainConfig(**kw))
    ref = jax_train.load_problem(jax_train.TrainConfig(**kw))
    _assert_same(got, ref)
    assert got.u_pad.f == (1 if tag != "ffm" else 2)


def test_train_config_matches():
    kw = dict(item_path="i", train_path="t", k=7, lam=0.3, self_side=False,
              freq=True, cg_precond="none")
    got, ref = torch_train.TrainConfig(**kw), jax_train.TrainConfig(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert [(f.name, f.default) for f in dataclasses.fields(got)] == [
        (f.name, f.default) for f in dataclasses.fields(ref)]
    assert dataclasses.asdict(got.hyper()) == dataclasses.asdict(ref.hyper())


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, a.const, a.help)
            for a in parser._actions}


def test_parser_options_match_but_the_platform():
    """The same options; ``--platform`` takes cuda or cpu, and the helps of
    ``--profile-dir``, ``--distributed`` and ``--ckpt-format`` name the
    port's profiler, torchrun's environment and the sharded format's
    writer."""
    got, ref = _options(torch_cli.build_parser()), _options(
        jax_cli.build_parser())
    assert got.pop("platform")[3] == ["cuda", "cpu"]
    ref.pop("platform")
    *got_trace, help_ = got.pop("profile_dir")
    assert "torch.profiler" in help_ and "jax" not in help_
    assert got_trace == list(ref.pop("profile_dir")[:-1])
    *got_dist, help_ = got.pop("distributed")
    assert "torchrun" in help_ and "jax" not in help_.lower()
    assert got_dist == list(ref.pop("distributed")[:-1])
    *got_ckpt, help_ = got.pop("ckpt_format")
    assert "torch.distributed.checkpoint" in help_
    assert got_ckpt == list(ref.pop("ckpt_format")[:-1])
    assert got == ref
    argv = ["items", "train", "-p", "va", "-k", "8", "-t", "3", "-l", "0.2",
            "-w", "0.05", "-r", "-0.5", "--ns", "--freq", "--seed", "4",
            "--dtype", "float64", "--eval-every", "2", "--ckpt", "ck",
            "--resume", "--jsonl", "m.jsonl", "--cg-precond", "none",
            "--blocked-bm", "128", "--refresh-every", "5", "--no-nan-guard",
            "--max-ploss", "9"]
    assert dataclasses.asdict(torch_cli.config_from_args(
        torch_cli.build_parser().parse_args(argv))) == dataclasses.asdict(
        jax_cli.config_from_args(jax_cli.build_parser().parse_args(argv)))


@pytest.mark.parametrize("self_side", [True, False])
def test_oracle_matches(self_side):
    """Gradient, Hv and objective of every block side, and one epoch."""
    rng = np.random.default_rng(11)
    prob, params = make_problem(rng, self_side=self_side, cg_precond="none")
    tprob = torch_oracle.OracleProblem(
        layout=BlockLayout.make(prob.layout.Du, prob.layout.Dv, self_side),
        hp=HyperParams(**dataclasses.asdict(prob.hp)), Xu=prob.Xu,
        Xv=prob.Xv, pos=prob.pos, freq_u=prob.freq_u, freq_v=prob.freq_v)
    assert torch_oracle.objective(tprob, params) == jax_oracle.objective(
        prob, params)
    V = rng.normal(size=(max(prob.layout.Du + prob.layout.Dv), prob.hp.k))
    for b, tb in zip(prob.layout.all_blocks(), tprob.layout.all_blocks()):
        assert (b.f1, b.f2, b.kind) == (tb.f1, tb.f2, tb.kind)
        for first in (True, False):
            G, hv = jax_oracle.grad_and_hv(prob, params, b, first)
            tG, thv = torch_oracle.grad_and_hv(tprob, params, tb, first)
            np.testing.assert_array_equal(tG, G)
            np.testing.assert_array_equal(thv(V[: G.shape[0]]),
                                          hv(V[: G.shape[0]]))
    ref, got = jax_oracle.oracle_epoch(prob, params), \
        torch_oracle.oracle_epoch(tprob, params)
    for name in ("W", "H"):
        for f12 in ref[name]:
            np.testing.assert_array_equal(got[name][f12], ref[name][f12])


def test_text_model_and_checkpoint_bytes_match(tmp_path):
    rng = np.random.default_rng(12)
    layout = BlockLayout.make((6, 4), (5, 3), True)
    params = {b.f12: {"W": rng.normal(size=(b.d1, 3)),
                      "H": rng.normal(size=(b.d2, 3))}
              for b in layout.all_blocks()}
    paths = []
    for tag, mod in (("torch", torch_train), ("jax", jax_train)):
        path = str(tmp_path / f"{tag}.txt")
        mod.save_text_model(path, params, layout, 3)
        paths.append(path)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    t_lay, t_k, t_params = torch_train.load_text_model(paths[0])
    j_lay, j_k, j_params = jax_train.load_text_model(paths[0])
    assert (t_lay.Du, t_lay.Dv, t_lay.self_side, t_k) == (
        j_lay.Du, j_lay.Dv, j_lay.self_side, j_k)
    _assert_same(t_params, j_params)
    cfg = dict(item_path="i", train_path="t", k=3)
    dirs = []
    for tag, mod in (("torch", torch_train), ("jax", jax_train)):
        ck = str(tmp_path / f"ck_{tag}")
        mod.save_checkpoint(ck, params, 7, mod.TrainConfig(**cfg),
                            layout={"fu": 2})
        dirs.append(ck)
    with open(os.path.join(dirs[0], "config.json"), "rb") as a, \
            open(os.path.join(dirs[1], "config.json"), "rb") as b:
        assert json.loads(a.read()) == json.loads(b.read())
    with zipfile.ZipFile(os.path.join(dirs[0], "ckpt.npz")) as a, \
            zipfile.ZipFile(os.path.join(dirs[1], "ckpt.npz")) as b:
        assert a.namelist() == b.namelist()
        for member in a.namelist():  # the .npy bytes (zip stamps aside)
            assert a.read(member) == b.read(member), member
    got, ref = torch_train.load_checkpoint(dirs[1]), \
        jax_train.load_checkpoint(dirs[0])
    _assert_same(got, ref)
    assert torch_train.has_checkpoint(dirs[0])


@pytest.mark.parametrize("kw", [dict(), dict(fu=1, fv=1),
                                dict(dims_u=(300, 40), dims_v=(50, 9))])
def test_synth_matches(kw, tmp_path):
    spec = dict(n_users=300, n_items=50, avg_pos=5.0, seed=9, **kw)
    got = torch_synth.generate_vectorized(torch_synth.SynthSpec(**spec))
    ref = jax_synth.generate_vectorized(jax_synth.SynthSpec(**spec))
    _assert_same(got, ref)
    a = torch_synth.write_dataset(str(tmp_path / "t"),
                                  torch_synth.SynthSpec(**spec))
    b = jax_synth.write_dataset(str(tmp_path / "j"),
                                jax_synth.SynthSpec(**spec))
    for pa, pb in zip(a, b):
        with open(pa, "rb") as fa, open(pb, "rb") as fb:
            assert fa.read() == fb.read()


def test_numpy_metrics_match():
    rng = np.random.default_rng(13)
    n, m = 30, 9
    scores = [rng.random(n) for _ in range(m)]
    scores[2][:] = 0.5  # ties
    labels = [rng.choice(n, size=3, replace=False) for _ in range(m)]
    at = rng.normal(size=m)
    assert torch_metrics.TOP_K_LADDER == jax_metrics.TOP_K_LADDER
    assert torch_metrics.validate_np(scores, labels, at, 25, n) == \
        jax_metrics.validate_np(scores, labels, at, 25, n)


def test_phase_timer_matches():
    for mod in (torch_profiling, jax_profiling):
        timer = mod.PhaseTimer()
        with timer.phase("a"):
            pass
        timer.add("b", 2.0)
        lines = []
        timer.report(lines.append)
        assert sorted(timer.summary()) == ["a", "b"]
        assert timer.summary()["b"] == {"seconds": 2.0, "calls": 1}
        assert len(lines) == 2


# ---------------------------------------------------------------------------
# prep/: the raw-data pipelines, run on tests/test_prep.py's raw CSVs
# ---------------------------------------------------------------------------


def _prep_raw(name: str, tmp_path):
    """(raw argument of the pipeline, its extra options): test_prep.py's
    miniature raw files of the Kaggle schema."""
    import test_prep

    if name == "kdd12":
        raw = str(tmp_path / "training.csv")
        test_prep.write_kdd12_raw(raw)
        return raw, ["--threshold", "2"]
    raw = str(tmp_path / "raw")
    getattr(test_prep, f"write_{name}_raw")(raw)
    return raw, ["--threshold", "3" if name == "outbrain" else "2"]


def _tree_bytes(root: str):
    out = {}
    for base, _, files in os.walk(root):
        for f in files:
            path = os.path.join(base, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


@pytest.mark.parametrize("name", ["kdd12", "kkbox", "outbrain"])
def test_prep_pipeline_outputs_match(name, tmp_path):
    """Each pipeline of the port's prep/ writes the original's files, byte
    for byte, from the same raw CSVs."""
    raw, opts = _prep_raw(name, tmp_path)
    outs = []
    for pkg in ("one_class_ffm_torch", "one_class_ffm_tpu"):
        mod = importlib.import_module(f"{pkg}.prep.{name}")
        out = str(tmp_path / pkg)
        assert mod.main(["all", "--raw", raw, "--out", out, *opts]) == 0
        outs.append(_tree_bytes(out))
    got, ref = outs
    assert sorted(got) == sorted(ref)
    assert len(ref) > 5
    for rel, data in ref.items():
        assert got[rel] == data, rel


@pytest.mark.parametrize("case", ["split", "subsample", "geo_handler"])
def test_prep_helpers_match(case, tmp_path):
    """The deterministic split, the subsample and the geo handler of the
    port's copies give the originals' results."""
    outs = []
    for pkg in ("one_class_ffm_torch", "one_class_ffm_tpu"):
        split = importlib.import_module(f"{pkg}.prep.split")
        encode = importlib.import_module(f"{pkg}.prep.encode")
        d = tmp_path / pkg
        d.mkdir()
        p = d / "x.ffm"
        p.write_text("".join(f"{i} 0:{i}:1\n" for i in range(200)))
        if case == "split":
            paths = split.split_file(str(p), seed=0)
            again = split.split_file(str(p), seed=0)
            assert again == paths
            outs.append([open(q).read() for q in paths])
        elif case == "subsample":
            outs.append(open(split.subsample(str(p))).read())
        else:
            sp = encode.FeatureSpace(1)
            outs.append([geo_ids for v in ("US>CA>803", "US>CA", "US>803",
                                           "US", "803", "US", "GB>ENG>1")
                         for geo_ids in [encode.geo_handler(sp, 0, v)]])
    got, ref = outs
    assert got == ref
    if case == "split":
        assert sum(txt.count("\n") for txt in got) == 200


def test_port_trains_on_its_prep_output(tmp_path):
    """The whole chain on the port: raw csv -> the port's prep -> the
    port's Trainer (tests/test_prep.py:139), its log rows those of the JAX
    Trainer on the same files from the same model."""
    import test_prep
    from one_class_ffm_torch.prep import kdd12

    raw = str(tmp_path / "training.csv")
    test_prep.write_kdd12_raw(raw, n=600)
    out = str(tmp_path / "out")
    assert kdd12.main(["all", "--raw", raw, "--out", out,
                       "--threshold", "1"]) == 0
    kw = dict(item_path=os.path.join(out, "ad.ffm"),
              train_path=os.path.join(out, "user.tr.ffm"),
              test_path=os.path.join(out, "user.va.ffm"), k=3, nr_pass=2,
              eval_every=2, dtype="float64", eval_chunk=32)
    init = jax_train.Trainer(jax_train.TrainConfig(**kw))
    init.init_state()
    model = str(tmp_path / "init.txt")
    jax_train.save_text_model(model, init.params_numpy(), init.data.layout,
                              3)
    rows = []
    for mod, extra in ((torch_train, dict(device="cpu")), (jax_train, {})):
        tr = mod.Trainer(mod.TrainConfig(init_model=model, **kw), **extra)
        tr.init_state()
        got = []
        tr.run(log=got.append)
        rows.append(got)
        m = tr.validate()
        assert 0.0 <= m["auc"] <= 1.0
    assert rows[0] == rows[1]
