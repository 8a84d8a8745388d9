"""Architecture configs the port serves — one module per architecture.

``get(name)`` returns the exact published config; ``get_smoke(name)``
returns a reduced same-family config for CPU tests.  Every arch of the
reference is here (dense: gemma-2b, qwen3-8b, minitron-4b,
h2o-danube-3-4b; moe: qwen3-moe-30b-a3b, qwen2-moe-a2.7b; ssm:
rwkv6-3b; hybrid: zamba2-7b; encdec: whisper-base; vlm:
llama-3.2-vision-90b) and the paper's own sweep, posh-micro (family
``micro``: buffer sizes, dtypes and repeats, not a model).
"""
from __future__ import annotations

import importlib

ARCHS = ("minitron_4b", "gemma_2b", "qwen3_8b", "h2o_danube3_4b",
         "whisper_base", "rwkv6_3b", "qwen2_moe_a2_7b", "qwen3_moe_30b_a3b",
         "llama32_vision_90b", "zamba2_7b", "posh_micro")

_ALIASES = {"minitron-4b": "minitron_4b", "gemma-2b": "gemma_2b",
            "qwen3-8b": "qwen3_8b", "h2o-danube-3-4b": "h2o_danube3_4b",
            "whisper-base": "whisper_base", "rwkv6-3b": "rwkv6_3b",
            "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
            "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
            "llama-3.2-vision-90b": "llama32_vision_90b",
            "zamba2-7b": "zamba2_7b", "posh-micro": "posh_micro"}


def canon(name: str) -> str:
    key = _ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCHS:
        raise NotImplementedError(
            f"repro_torch has no config for {name!r} (ported: "
            f"{', '.join(ARCHS)})")
    return key


def get(name: str):
    return importlib.import_module(f"{__name__}.{canon(name)}").config()


def get_smoke(name: str):
    return importlib.import_module(f"{__name__}.{canon(name)}").smoke_config()
