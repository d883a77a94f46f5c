"""What the benchmark imports: never JAX nor the JAX package, and, in the
reference, nothing of the program.  Top-level names are compared whole:
the port's name begins with the JAX package's."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

PB = Path(harness.__file__).resolve().parent
FILES = sorted(p for p in PB.rglob("*.py") if "tests" not in p.parts)
REFERENCE = sorted((PB / "reference").rglob("*.py"))


def _top_names(path):
    """Top-level names of every absolute import in ``path``."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_anywhere(path):
    assert not _top_names(path) & harness.FORBIDDEN


@pytest.mark.parametrize("path", REFERENCE,
                         ids=lambda p: str(p.relative_to(PB)))
def test_reference_imports_nothing_of_the_program(path):
    assert not _top_names(path) & (harness.FORBIDDEN
                                   | {"nbody_streams_tpu_torch"})


def test_whole_names_are_compared():
    # the port is allowed, a module named like the JAX package is not
    assert "nbody_streams_tpu_torch".split(".")[0] not in harness.FORBIDDEN
    assert "nbody_streams_tpu.sim".split(".")[0] in harness.FORBIDDEN


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench import harness\n"
            "harness.run('plummer_iso.n65k', 3, 0.2, False, device='cpu',"
            " n_body=256)\n"
            "print(harness.forbidden_modules())" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"
