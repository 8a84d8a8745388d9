"""What the benchmark's process may hold: no JAX and no JAX package
(top-level names compared whole: ``repro_torch`` is the system under
test, ``repro`` is not), and a reference that loads none of the
program."""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.serve", "reprox", "jaxtyping",
         "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax.linen", "jax.numpy", "jaxlib", "repro", "repro.core"]


def _loaded(code: str) -> list:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(HERE.parent), str(HERE.parent / "src")]))
    out = subprocess.run([sys.executable, "-c", code +
                          "\nimport sys, json; print(json.dumps(sorted("
                          "sys.modules)))"], capture_output=True, text=True,
                         env=env, cwd=HERE.parent, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_run_path_loads_no_jax_nor_the_jax_package():
    code = "\n".join(
        ["from perfbench import harness",
         "from perfbench.lib import qwen3, trace"] +
        [f"harness.load_module(harness.HERE / 'kinds' / '{k}', 'k{i}')"
         for i, k in enumerate(sorted(os.listdir(HERE / "kinds")))
         if k.endswith(".py")] +
        ["import repro_torch.serve, repro_torch.train, repro_torch.core"])
    mods = _loaded(code)
    assert "repro_torch" in mods
    assert harness.forbidden_modules(mods) == []


@pytest.mark.parametrize("name", sorted(
    p.stem for p in (HERE / "reference").glob("*.py")))
def test_the_reference_loads_none_of_the_program(name):
    mods = _loaded(f"import perfbench.reference.{name}")
    assert [m for m in mods if m.split(".")[0] in
            ("repro_torch", "repro", "jax", "jaxlib", "flax")] == []
    tree = ast.parse((HERE / "reference" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            assert node.module.split(".")[0] == "perfbench" or \
                node.module.split(".")[0] in sys.stdlib_module_names or \
                node.module.split(".")[0] in ("torch", "numpy"), node.module
