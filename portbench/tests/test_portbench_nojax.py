"""Nothing a run or the reference loads is JAX, flax or iltpu (the JAX
package), compared by whole top-level names: `iltpu_torch` is the port."""

import ast
import os
import subprocess
import sys

from portbench import harness, run

HERE = os.path.dirname(harness.__file__)


def test_top_level_names_compared_whole(monkeypatch):
    for name in ("iltpu_torch", "iltpu_torch.trainer", "jaxtyping", "flaxen", "iltpux"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not set(run.forbidden_modules()) & {"iltpu_torch", "jaxtyping", "flaxen", "iltpux"}
    monkeypatch.setitem(sys.modules, "iltpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"iltpu", "jaxlib"} <= set(run.forbidden_modules())


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.run as r, portbench.harness, portbench.correct, portbench.calibrate\n"
            "import portbench.faults, iltpu_torch.trainer, iltpu_torch.config\n"
            "import portbench.algorithms.gail, portbench.algorithms.sac\n"
            "import portbench.algorithms.dril\n"
            "import portbench.reference.bc, portbench.reference.dril, portbench.work.dril\n"
            "print(r.forbidden_modules())" % harness.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]", out.stdout


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(HERE, "reference")):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(HERE, "reference", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            for m in mods:
                assert m.split(".")[0] in ("torch", "numpy", "math", "typing", "portbench"), (name, m)
                assert not m.startswith("portbench.") or m.startswith("portbench.reference"), (name, m)


def test_harness_imports_no_jax_and_names_no_algorithm():
    """No file of the harness imports JAX, flax or iltpu (the adapters, the
    references and the work counts of every algorithm among them); outside
    an algorithm's adapter, its reference and its work counts, no file the
    harness and the check run names GAIL or DRIL."""
    files = [os.path.join(d, n) for d in (HERE, os.path.join(HERE, "algorithms"),
                                          os.path.join(HERE, "reference"), os.path.join(HERE, "work"),
                                          os.path.join(HERE, "metrics"))
             for n in os.listdir(d) if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            text = f.read()
        for node in ast.walk(ast.parse(text)):
            mods = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) and node.module else [])
            assert not {m.split(".")[0] for m in mods} & set(run.FORBIDDEN), (path, mods)
    scanned = {os.path.relpath(p, HERE) for p in files}
    assert {"algorithms/dril.py", "reference/bc.py", "reference/dril.py", "work/dril.py"} <= scanned
    for name in ("harness.py", "correct.py", "weights.py", "faults.py", "run.py", "calibrate.py",
                 "algorithms/__init__.py", "algorithms/sac.py"):
        with open(os.path.join(HERE, name)) as f:
            text = f.read().lower()
        assert "gail" not in text and "dril" not in text, name
