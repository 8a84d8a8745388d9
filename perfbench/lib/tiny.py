"""A small copy of the benchmark for the CPU tests: ``make(dst)`` copies
``perfbench/`` under ``dst`` and adds, as new files only, tiny
configurations, mixes and cells of each kind beside the real ones (the
same published keys at smoke widths, the same settings scaled down), so
a whole run of each kind takes a second or two on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SMALL = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 96,
         "num_hidden_layers": 2, "vocab_size": 128}


def _load(rel: str) -> dict:
    with open(REPO / "perfbench" / rel) as f:
        return json.load(f)


def _dump(obj, path: Path) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make(dst) -> Path:
    """A benchmark root at ``dst`` (``BENCHMARK.json`` and
    ``perfbench/``) with the cells ``tiny.serve``, ``tiny.moe``,
    ``tiny.train`` and ``tiny.rma``; returns ``dst``."""
    dst = Path(dst)
    bench = dst / "perfbench"
    shutil.copytree(REPO / "perfbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    serve = dict(_load("configs/qwen3-8b-bf16.json"), name="tiny-serve",
                 torch_dtype="float32", **SMALL)
    serve["serve"] = {"page_tokens": 4, "n_pages": 64, "max_batch": 4,
                      "max_seq": 64, "prefill_chunk": 8, "tick_tokens": 32,
                      "attn_impl": "kernel", "warm_requests": 2,
                      "warm_ticks": 2, "trace_seconds": 0.2,
                      "check_tokens": 16}
    moe = dict(_load("configs/qwen3-moe-30b-a3b-bf16.json"), **SMALL,
               name="tiny-moe", torch_dtype="float32", num_experts=8,
               num_experts_per_tok=2, moe_intermediate_size=32,
               capacity_factor=4.0, serve=serve["serve"])
    # served in float32, the tiny models' tokens are the reference's best
    # (gap 0), while their float8 control reads gaps of 0.009 and more:
    # limits of their own, so that the control fails at this size too
    serve["limits"] = {"max_logit_gap": 1e-3}
    moe["limits"] = {"mean_logit_gap": 1e-3, "max_logit_gap": 1e-3}
    train = dict(_load("configs/qwen3-8b-8l-f32.json"), name="tiny-train",
                 **SMALL)
    rma = dict(_load("configs/posh-micro-8pe.json"), name="tiny-rma",
               elems=1024)
    mixes = {
        "tiny-long": dict(_load("traffic/longprompt.json"), clients=4,
                          block=16,
                          prompt_tokens={"dist": "loguniform", "lo": 8,
                                         "hi": 40},
                          output_tokens={"dist": "loguniform", "lo": 1,
                                         "hi": 8}),
        "tiny-train": dict(_load("traffic/train-4k.json"), rows=4, seq=32,
                           microbatches=2),
        "tiny-rma": dict(_load("traffic/rma-large.json"), sample_every=50,
                         trace_seconds=0.2)}
    for cfg in (serve, moe, train, rma):
        _dump(cfg, bench / "configs" / f"{cfg['name']}.json")
    for name, mix in mixes.items():
        _dump(mix, bench / "traffic" / f"{name}.json")
    with open(REPO / "BENCHMARK.json") as f:
        spec = json.load(f)
    cells = {"tiny.serve": ("tiny-serve", "tiny-long",
                            "qwen3-8b.longprompt"),
             "tiny.moe": ("tiny-moe", "tiny-long",
                          "qwen3-moe-30b-a3b.longprompt"),
             "tiny.train": ("tiny-train", "tiny-train", "qwen3-8b.train-4k"),
             "tiny.rma": ("tiny-rma", "tiny-rma", "posh-micro.rma-16m")}
    for cell, (cfg, mix, like) in cells.items():
        spec["configs"].append({"name": cfg, "source": "smoke",
                                "file": f"perfbench/configs/{cfg}.json",
                                "reduced": [], "why": "CPU tests"})
        spec["workloads"].append({"name": cell, "config": cfg,
                                  "traffic": mix, "chips": 1,
                                  "why": "CPU tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell)
    _dump(spec, dst / "BENCHMARK.json")
    return dst
