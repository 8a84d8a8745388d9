"""repro_torch stands alone: importing the package and every submodule
(the serving slice, the communication library: core, comm, the copy
and combine kernels, comm_bench, and the training slice: the flash
kernel, flash/lm/registry, parallel, data, train, the train launcher,
and the MoE slice: the MoE configs and the MoE layer in models/mlp),
and ``chip_smoke.py``, pulls in no
JAX and nothing of the JAX package ``repro`` — checked by a clean
subprocess's ``sys.modules`` and by an AST scan of every import
statement."""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        out.extend(os.path.join(dirpath, n) for n in sorted(names)
                   if n.endswith(".py"))
    return out


def _modules():
    mods = []
    for path in _sources()[1:]:
        rel = os.path.relpath(path, os.path.join(ROOT, "src"))[:-3]
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return sorted(mods)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print('BAD', bad)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout
    assert len(_modules()) >= 40


def test_the_comm_slice_is_covered():
    """The communication library's modules are among those imported and
    scanned above (a module left out of the walk would go unchecked)."""
    want = {"repro_torch.core." + m for m in (
        "teams", "safety", "heap", "p2p", "collectives", "ordering",
        "signals", "atomics")} | {
        "repro_torch.comm", "repro_torch.comm.communicator",
        "repro_torch.comm.pallas_backend", "repro_torch.kernels.symm_copy",
        "repro_torch.kernels.reduce_combine", "repro_torch.kernels.ops",
        "repro_torch.launch.comm_bench"}
    assert want <= set(_modules())


def test_the_training_slice_is_covered():
    want = {"repro_torch.kernels.flash_attention", "repro_torch.models.flash",
            "repro_torch.models.registry", "repro_torch.parallel",
            "repro_torch.parallel.ctx", "repro_torch.data",
            "repro_torch.data.pipeline", "repro_torch.train",
            "repro_torch.train.optimizer", "repro_torch.train.grad",
            "repro_torch.train.step", "repro_torch.train.tree",
            "repro_torch.configs.gemma_2b", "repro_torch.launch.train"}
    assert want <= set(_modules())


def test_the_serving_slice_is_covered():
    want = {"repro_torch.serve." + m for m in (
        "engine", "kv_cache", "scheduler", "sampling", "slo", "spec",
        "threefry", "traffic")} | {"repro_torch.launch.serve"}
    assert want <= set(_modules())


def test_the_moe_slice_is_covered():
    want = {"repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.models.mlp",
            "repro_torch.models.lm", "repro_torch.weights"}
    assert want <= set(_modules())


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_repro(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"
