"""The port's runnable examples (nbody_streams_tpu_torch/examples/).

* every script (and the notebook generator, and the code cells of the
  notebooks it writes) byte-compiles and imports neither jax nor the JAX
  package (an AST scan);
* every example of the JAX package has its copy;
* the ``main()``-guarded scripts import cleanly;
* the SCF demo and the ring's demo run end to end at tiny N on the CPU in
  a subprocess, and the headline example fails without a card instead of
  falling back.
"""
import ast
import json
import os
import py_compile
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "nbody_streams_tpu_torch" / "examples"
NOTEBOOKS = EXAMPLES / "notebooks"

# scripts with an `if __name__ == "__main__"` guard (as the JAX package's)
GUARDED = [
    "density_methods.py",
    "dynamical_friction_tutorial.py",
    "mw_lmc_stream.py",
    "run_simulation_multispecies.py",
    "stream_nbody.py",
]
# every example is ported (the multi-device ring's demo since the ring)
NOT_PORTED = set()


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for f in sorted(EXAMPLES.glob("*.py")) + [NOTEBOOKS /
                                              "make_notebooks.py"]:
        yield f.name, f.read_text()
    for nb in sorted(NOTEBOOKS.glob("*.ipynb")):
        cells = json.loads(nb.read_text())["cells"]
        for i, c in enumerate(cells):
            if c["cell_type"] == "code":
                yield f"{nb.name}[{i}]", "".join(c["source"])


def test_every_example_is_ported():
    ported = {f.name for f in EXAMPLES.glob("*.py")}
    jax_side = {f.name for f in (REPO / "examples").glob("*.py")}
    assert ported == jax_side - NOT_PORTED
    assert {f.name for f in NOTEBOOKS.glob("*.ipynb")} == {
        "plummer_stability.ipynb", "mw_lmc_stream.ipynb"}


def test_examples_compile_and_leave_jax_out():
    for f in sorted(EXAMPLES.glob("*.py")) + [NOTEBOOKS /
                                              "make_notebooks.py"]:
        py_compile.compile(str(f), doraise=True)
    n = 0
    for name, src in _sources():
        for mod in _imports(ast.parse(src, name)):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "nbody_streams_tpu"), (
                f"{name} imports {mod}")
        n += 1
    assert n > 12


@pytest.mark.parametrize("name", GUARDED)
def test_guarded_example_imports(name, monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_torch_example_{name[:-3]}", EXAMPLES / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.main)


def _run(tmp_path, script, *args, timeout=300):
    env = dict(os.environ, MPLBACKEND="Agg", CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, str(EXAMPLES / script), *args], cwd=tmp_path,
        env=env, timeout=timeout, capture_output=True, text=True)


def test_scf_expansion_example_tiny_on_cpu(tmp_path):
    proc = _run(tmp_path, "scf_expansion.py", "512", "4", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "scf run: 4 steps" in proc.stdout
    assert "rel force err" in proc.stdout   # the accuracy-ladder table


def test_sharded_million_example_tiny_on_cpu(tmp_path):
    proc = _run(tmp_path, "sharded_million.py", "600", "cpu")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert "8 device(s): cpu" in proc.stdout
    assert "cpu/sharded" in proc.stdout
    assert "10 steps at N=600 on 8 device(s)" in proc.stdout


def test_examples_need_the_card(tmp_path):
    """architecture='auto' is the card: without one the example raises,
    naming the CPU option, instead of running on the CPU."""
    proc = _run(tmp_path, "plummer_stability.py", "256")
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "architecture='cpu'" in proc.stderr
