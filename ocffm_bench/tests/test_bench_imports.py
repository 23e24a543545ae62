"""What the benchmark may import: no module whose top-level name is jax,
jaxlib, flax or one_class_ffm_tpu anywhere it runs, and nothing of the
program in the reference.  Names are compared whole: the port's name
begins with the JAX package's."""

import ast
import os
import subprocess
import sys

import pytest

from ocffm_bench import harness

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = {"jax", "jaxlib", "flax", "one_class_ffm_tpu"}


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_names(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_whole_names_not_prefixes():
    assert "one_class_ffm_torch".split(".")[0] not in FORBIDDEN
    assert "one_class_ffm_torch".startswith("one_class_ffm_t")


@pytest.mark.parametrize("path", sorted(sources()), ids=os.path.basename)
def test_no_jax_anywhere(path):
    assert not set(top_names(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=os.path.basename)
def test_reference_imports_nothing_of_the_program(path):
    names = set(top_names(path))
    assert "one_class_ffm_torch" not in names
    assert not names & FORBIDDEN


def test_a_run_loads_no_jax():
    """A process that imports the harness, both traffic runners and the program's
    entry points holds no forbidden module."""
    code = ("import sys; sys.path.insert(0, %r); "
            "import ocffm_bench.drivers.train, ocffm_bench.drivers.rank, "
            "ocffm_bench.calibrate; "
            "import one_class_ffm_torch.train, one_class_ffm_torch.predict; "
            "from ocffm_bench import harness; "
            "print(harness.forbidden_modules())" % os.path.dirname(BENCH))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_sees_a_loaded_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert harness.forbidden_modules() == ["jaxlib"]
