"""repro_torch.analysis — correctness tooling for the shmem memory model
(counterpart of ``repro.analysis``).

Two complementary checkers over the paper's §3.2 completion model
(puts complete locally at issue; delivery is unordered until ``fence``
— per destination — or ``quiet`` — full barrier):

  shmemcheck   dynamic happens-before race detection instrumented into
               ``repro_torch.core.ordering.CommQueue`` and
               ``repro_torch.core.heap.SymmetricHeap`` behind a
               zero-cost-when-off hook (disabled, the hot path pays one
               global load + is-None test).  Enable with
               ``shmemcheck.enable()``, or run pytest with
               ``REPRO_SHMEMCHECK=1 -p repro_torch.analysis.pytest_arm``.

  lint         a static AST pass over ``src/repro_torch`` enforcing the
               comm-API invariants that hold by convention: every
               ``*_nbi`` issue drained on all paths (or annotated
               ``# shmem: deferred-drain``), no ``torch.distributed``
               collective and no direct ``core.collectives`` call
               outside the comm substrate, no ``SymHandle`` used past
               its ``free``, no drain inside a drain callback.  CLI:
               ``python -m repro_torch.analysis.lint``.
"""
from . import shmemcheck
from .shmemcheck import (Finding, ShmemChecker, compare_heaps, disable,
                         enable, get_checker, is_enabled, report, reset,
                         suspended)

__all__ = [
    "shmemcheck", "lint",
    "Finding", "ShmemChecker", "enable", "disable", "is_enabled",
    "get_checker", "report", "reset", "suspended", "compare_heaps",
    "LintError", "lint_paths", "lint_source",
]

_LINT_NAMES = ("LintError", "lint_paths", "lint_source")


def __getattr__(name):
    # the lint loads on first use, so that ``python -m
    # repro_torch.analysis.lint`` runs a module not yet imported
    if name == "lint" or name in _LINT_NAMES:
        import importlib
        lint = importlib.import_module(f"{__name__}.lint")
        return lint if name == "lint" else getattr(lint, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
