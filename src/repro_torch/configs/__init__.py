"""Architecture configs the port serves — one module per architecture.

``get(name)`` returns the exact published config; ``get_smoke(name)``
returns a reduced same-family config for CPU tests.  Only the archs
whose family the port serves or trains are here (dense: gemma-2b,
qwen3-8b; moe: qwen3-moe-30b-a3b, qwen2-moe-a2.7b); the others arrive
with their family.
"""
from __future__ import annotations

import importlib

ARCHS = ("gemma_2b", "qwen3_8b", "qwen3_moe_30b_a3b", "qwen2_moe_a2_7b")

_ALIASES = {"gemma-2b": "gemma_2b", "qwen3-8b": "qwen3_8b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b"}


def canon(name: str) -> str:
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCHS:
        raise NotImplementedError(
            f"repro_torch has no config for {name!r} yet (ported: "
            f"{', '.join(ARCHS)}); other archs arrive with their family")
    return key


def get(name: str):
    return importlib.import_module(f"{__name__}.{canon(name)}").config()


def get_smoke(name: str):
    return importlib.import_module(f"{__name__}.{canon(name)}").smoke_config()
