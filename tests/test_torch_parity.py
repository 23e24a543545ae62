"""The port's parity harness (``python -m one_class_ffm_torch.parity``).

Its data writer gives ``scripts/parity_check.py``'s files byte for byte,
and one paired trial runs the committed C++ reference binary against
``python -m one_class_ffm_torch --platform cpu``."""

import argparse
import ast
import contextlib
import importlib.util
import io
import math
import os

import pytest

from one_class_ffm_torch import parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "parity_check_script", os.path.join(ROOT, "scripts",
                                            "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("variant", ["ffm-freq", "fm-fm--ns"])
def test_gen_variant_writes_the_scripts_files(tmp_path, variant):
    script = _script()
    paths = []
    for tag, mod in (("port", parity), ("script", script)):
        d = tmp_path / tag
        d.mkdir()
        *files, flags = mod.gen_variant(str(d), variant, 120, 30, seed=1003)
        paths.append((files, flags))
    (ours, o_flags), (theirs, t_flags) = paths
    assert o_flags == t_flags
    assert [os.path.basename(p) for p in ours] == [
        os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            data = fa.read()
            assert data == fb.read() and data


def test_run_pair_against_the_reference_binary(tmp_path):
    binary = parity.build_reference()
    assert binary == os.path.join(ROOT, "scripts", "ref_build", "train")
    files = parity.gen_variant(str(tmp_path), "mf-mf--ns", 300, 40, seed=1000)
    *paths, flags = files
    # the reference prints a metric row every 10 epochs (ffm.cpp:1155)
    args = argparse.Namespace(k=8, lam=0.05, omega=0.1, epochs=10,
                              ref_cache=None, our_platform="cpu",
                              our_dtype="float32", our_cg="auto")
    ref, ours = parity.run_pair(binary, tuple(paths), flags, args, seed=0)
    assert sorted(ref) == sorted(ours)
    assert set(parity.METRICS) <= set(ref)
    assert all(math.isfinite(v) for v in (*ref.values(), *ours.values()))
    assert ours["p@5"] > 0


def _defs(path):
    with open(path) as fh:
        tree = ast.parse(fh.read())
    return {node.name: node for node in tree.body
            if isinstance(node, ast.FunctionDef)}


def test_loop_helpers_have_the_scripts_syntax_trees():
    """The paired-trial helpers are the script's; ``run_pair`` runs the
    port's module where the script runs the JAX package's."""
    ours, theirs = _defs(parity.__file__), _defs(_script().__file__)
    for name in ("row_metrics", "flatten_fields", "_ref_cache_path",
                 "mean_std"):
        assert ast.dump(ours[name]) == ast.dump(theirs[name]), name
    run_pair = ast.dump(ours["run_pair"])
    assert run_pair.count("'one_class_ffm_torch'") == 1
    assert run_pair.replace("'one_class_ffm_torch'",
                            "'one_class_ffm_tpu'") == ast.dump(
        theirs["run_pair"])


def test_main_takes_the_scripts_options():
    """The same options as the script, by name, and its tier presets; the
    port's trainer runs on cuda (the default) or cpu, nothing else."""
    def options(path):
        with open(path) as fh:
            return sorted(ln.split('"')[1] for ln in fh
                          if ln.strip().startswith('ap.add_argument("--'))

    assert options(parity.__file__) == options(_script().__file__)
    main = ast.dump(_defs(parity.__file__)["main"])
    for preset in ("50000", "5000", "100", "10", "2000", "150", "20"):
        assert f"Constant(value={preset})" in main
    err = io.StringIO()
    with pytest.raises(SystemExit) as exc, contextlib.redirect_stderr(err):
        parity.main(["--our-platform", "auto"])
    assert exc.value.code == 2 and "invalid choice" in err.getvalue()
