"""The program's view of a Qwen3 configuration: ``repro_torch``'s
``ArchConfig`` built from the published keys of ``configs/<name>.json``
(imported from the program when called, never by the reference)."""
from __future__ import annotations

from perfbench.lib import weights

QWEN3 = ("Qwen3ForCausalLM", "Qwen3MoeForCausalLM")


def program_config(cfg: dict, max_seq: int):
    """The program's ``ArchConfig`` of a configuration's published keys,
    serving or training sequences of up to ``max_seq`` tokens."""
    from repro_torch.configs.base import ArchConfig, MoEConfig
    arch = cfg["architectures"][0]
    if arch not in QWEN3 or cfg["hidden_act"] != "silu":
        raise ValueError(f"{cfg['name']}: the benchmark runs the Qwen3 "
                         f"decoders (qk-norm, SwiGLU), not {arch}")
    w = weights.dims(cfg)
    moe = None
    if w["experts"]:
        moe = MoEConfig(num_experts=w["experts"],
                        top_k=int(cfg["num_experts_per_tok"]),
                        expert_ff=w["eff"],
                        capacity_factor=float(cfg["capacity_factor"]))
    return ArchConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        n_layers=w["layers"], d_model=w["d"], n_heads=w["h"], n_kv=w["hkv"],
        head_dim=w["dh"], d_ff=w["eff"] if moe else w["ff"], vocab=w["v"],
        act="swiglu", qk_norm=True, rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=weights.tied(cfg), norm_eps=float(cfg["rms_norm_eps"]),
        moe=moe, max_seq=int(max_seq))
