"""repro_torch stands alone: importing the package and every submodule
(the serving slice with its control plane — disaggregated cells, the
page pool, the AMO router — the communication library: core, comm, the copy
and combine kernels, comm_bench, and the training slice: the flash
kernel, flash/lm/registry, parallel, data, train, the train launcher,
the MoE slice: the MoE configs and the MoE layer in models/mlp, the
checkpoint slice: ckpt and ft, data parallelism: comm.bucketing and
comm.compress, the RWKV / Mamba-hybrid slice: models.rwkv,
models.ssm and the four new configs, and the cross-attention slice:
models.encdec and the whisper-base and llama-3.2-vision-90b configs,
and the MoE / tensor-parallel training slice: comm.autograd, the
sequence-parallel operators in parallel.ctx, registry.tp_specs and the
training layout in weights, and the slice that completes A10: the ctx
attention layout, the flash kernel's per-PE query offset and every
family at tp > 1, in modules that were there, and the tooling slice:
the analysis package (shmemcheck, the lint, the pytest plugin), the
launch tooling (mesh, shapes, roofline, the dry run), the posh-micro
config), ``chip_smoke.py`` and the examples under ``examples/torch/``,
pulls in no JAX and nothing of the JAX package ``repro`` — checked by a
clean subprocess's ``sys.modules`` and by an AST scan of every import
statement."""
import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "src", "repro_torch")
EXAMPLES = os.path.join(ROOT, "examples", "torch")
# a ROADMAP label (A1 .. A12) in an error message
A_LABEL = re.compile(r"\bA\d{1,2}\b(?!\.\d)")


def _package_files():
    out = []
    for dirpath, _, names in os.walk(PKG):
        out.extend(os.path.join(dirpath, n) for n in sorted(names)
                   if n.endswith(".py"))
    return out


def _sources():
    examples = sorted(os.path.join(EXAMPLES, n) for n in os.listdir(EXAMPLES)
                      if n.endswith(".py"))
    return [os.path.join(ROOT, "chip_smoke.py")] + _package_files() \
        + examples


def raises_citing_a_label() -> list:
    """Every ``raise`` in the port, ``chip_smoke.py`` or the examples whose
    message cites a ROADMAP label (A1 .. A12): ``path:line``."""
    out = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Raise) and any(
                    A_LABEL.search(c.value) for c in ast.walk(node)
                    if isinstance(c, ast.Constant)
                    and isinstance(c.value, str)):
                out.append(f"{path}:{node.lineno}")
    return out


def _modules():
    mods = []
    for path in _package_files():
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
    want = {"repro_torch.comm.bucketing", "repro_torch.comm.compress",
            "repro_torch.tree",
            "repro_torch.kernels.flash_attention", "repro_torch.models.flash",
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
        "threefry", "traffic", "disagg", "page_pool", "amo_router")} | {
        "repro_torch.launch.serve"}
    assert want <= set(_modules())


def test_the_moe_slice_is_covered():
    want = {"repro_torch.configs.qwen3_moe_30b_a3b",
            "repro_torch.configs.qwen2_moe_a2_7b", "repro_torch.models.mlp",
            "repro_torch.models.lm", "repro_torch.weights"}
    assert want <= set(_modules())


def test_the_ckpt_slice_is_covered():
    want = {"repro_torch.ckpt", "repro_torch.ckpt.checkpoint",
            "repro_torch.ckpt.hotswap", "repro_torch.ft",
            "repro_torch.ft.runtime"}
    assert want <= set(_modules())


def test_the_families_slice_is_covered():
    want = {"repro_torch.models.rwkv", "repro_torch.models.ssm",
            "repro_torch.configs.minitron_4b",
            "repro_torch.configs.h2o_danube3_4b",
            "repro_torch.configs.rwkv6_3b", "repro_torch.configs.zamba2_7b"}
    assert want <= set(_modules())


def test_the_cross_attention_slice_is_covered():
    want = {"repro_torch.models.encdec", "repro_torch.configs.whisper_base",
            "repro_torch.configs.llama32_vision_90b"}
    assert want <= set(_modules())


def test_the_moe_and_tp_training_slice_is_covered():
    """The differentiable collectives are a module of their own; the
    sequence-parallel operators, the TP specs and the TP layout (with
    its inverse) live in modules the walk covers, and import without
    JAX."""
    want = {"repro_torch.comm.autograd", "repro_torch.parallel.ctx",
            "repro_torch.models.registry", "repro_torch.weights",
            "repro_torch.train.grad", "repro_torch.train.step",
            "repro_torch.train.optimizer", "repro_torch.launch.train"}
    assert want <= set(_modules())
    from repro_torch.models.registry import tp_specs
    from repro_torch.parallel import sp_gather, sp_scatter
    from repro_torch.weights import shard_for_tp, unshard
    assert all(callable(f) for f in (tp_specs, sp_gather, sp_scatter,
                                     shard_for_tp, unshard))


def test_the_tp_families_slice_is_covered():
    """A10 is whole: no ``raise`` in the port (nor in ``chip_smoke.py``)
    cites it, nor is its refusal message left; posh-micro, which raised
    citing A12 before, is the port's config and no ``raise`` cites any
    A-label; the per-PE flash offset and the ``sp`` switch import
    without JAX."""
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            src = f.read()
        assert "A10_TP" not in src, path
        for node in ast.walk(ast.parse(src, filename=path)):
            if isinstance(node, ast.Raise):
                texts = [c.value for c in ast.walk(node)
                         if isinstance(c, ast.Constant)
                         and isinstance(c.value, str)]
                assert not any("A10" in t for t in texts), \
                    f"{path}:{node.lineno}"
    from repro_torch import configs
    from repro_torch.configs import posh_micro
    assert configs.get("posh-micro") == posh_micro.config()
    assert raises_citing_a_label() == []
    from repro_torch.kernels.flash_attention import query_positions
    from repro_torch.parallel import ParallelCtx
    assert query_positions(0, 2, "cpu", 4, 2, 8).tolist() == \
        [[0, 1], [0, 1], [8, 9], [8, 9]]
    assert ParallelCtx().sp and not ParallelCtx(sp=False).sp


def test_the_tooling_slice_is_covered():
    """The analysis package, the launch tooling and the posh-micro config
    are among the modules imported and scanned above, and the examples
    under ``examples/torch/`` among the files scanned."""
    want = {"repro_torch.analysis", "repro_torch.analysis.lint",
            "repro_torch.analysis.shmemcheck",
            "repro_torch.analysis.pytest_arm", "repro_torch.launch.mesh",
            "repro_torch.launch.shapes", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.configs.posh_micro"}
    assert want <= set(_modules())
    names = {os.path.basename(p) for p in _sources()
             if os.path.dirname(p) == EXAMPLES}
    assert {"quickstart.py", "train_lm.py", "serve_quickstart.py",
            "serve_decode.py", "shmem_pingpong.py"} <= names


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
