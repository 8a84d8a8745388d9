"""ArchConfig — the single config schema every architecture instantiates."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int               # per-expert hidden size
    shared_ff: int = 0           # fused shared-expert hidden size (0 = none)
    capacity_factor: float = 1.25
    padded_experts: Optional[int] = None  # EP divisibility padding

    def experts_padded(self, tp: int) -> int:
        if self.padded_experts:
            return self.padded_experts
        e = self.num_experts
        return -(-e // tp) * tp


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"          # swiglu | geglu | gelu
    qk_norm: bool = False
    swa_window: Optional[int] = None     # sliding-window attention
    rope_theta: float = 10000.0
    use_rope: bool = True                # whisper: absolute positions
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # MoE
    moe: Optional[MoEConfig] = None

    # SSM / RWKV
    ssm_state: int = 0                  # Mamba2 state size (0 = no ssm)
    ssm_expand: int = 2
    ssm_conv: int = 4
    rwkv_head_dim: int = 0              # >0 => RWKV6 time-mix layers
    rwkv_padded_heads: Optional[int] = None

    # hybrid (zamba2): shared attention block every k mamba layers
    shared_attn_every: int = 0

    # enc-dec (whisper): encoder layers (n_layers = decoder layers)
    enc_layers: int = 0
    enc_frames: int = 1500              # stub frontend output length

    # vlm: cross-attention to image embeddings every k layers
    cross_attn_every: int = 0
    img_tokens: int = 1601              # stub patch embeddings

    # training defaults
    max_seq: int = 4096

    # --- derived -----------------------------------------------------
    def padded_vocab(self, tp: int) -> int:
        return -(-self.vocab // tp) * tp

    def attn_layout(self, tp: int) -> str:
        """'head' when query heads divide TP; otherwise 'ctx'
        (sequence-parallel attention with gathered KV) — see DESIGN.md."""
        if self.rwkv_head_dim or (self.ssm_state and not self.shared_attn_every):
            return "head"  # attention-free: layout handled by the block
        return "head" if self.n_heads % tp == 0 else "ctx"

    def kv_per_rank(self, tp: int) -> int:
        return max(self.n_kv // tp, 1)

    def heads_per_rank(self, tp: int) -> int:
        if self.n_heads % tp:
            raise ValueError(f"{self.name}: {self.n_heads} heads not divisible "
                             f"by tp={tp} (ctx layout keeps all heads)")
        return self.n_heads // tp

    def param_count(self) -> int:
        """Approximate parameter count (embedding + blocks), for
        MODEL_FLOPS accounting."""
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.rwkv_head_dim:
            att = 6 * d * d       # r,k,v,g,w,out (+ small time-mix params)
            ff = 2 * d * self.d_ff
            return emb + l * (att + ff)
        attn_q = d * self.n_heads * self.head_dim
        attn_kv = 2 * d * self.n_kv * self.head_dim
        attn_o = self.n_heads * self.head_dim * d
        if self.moe:
            gl = 3 if self.act in ("swiglu", "geglu") else 2
            routed = self.moe.num_experts * gl * d * self.moe.expert_ff
            shared = gl * d * self.moe.shared_ff
            ff = routed + shared + d * self.moe.num_experts  # + router
        else:
            gl = 3 if self.act in ("swiglu", "geglu") else 2
            ff = gl * d * self.d_ff
        blocks = l * (attn_q + attn_kv + attn_o + ff)
        if self.ssm_state:
            d_in = self.ssm_expand * d
            mamba = l * (2 * d * d_in + d_in * d + d_in * (2 * self.ssm_state))
            n_shared = (l // self.shared_attn_every) if self.shared_attn_every else 0
            shared_blk = (attn_q + attn_kv + attn_o + gl * d * self.d_ff)
            blocks = mamba + n_shared * 0 + (shared_blk if n_shared else 0)
        if self.enc_layers:
            blocks += self.enc_layers * (attn_q + attn_kv + attn_o + ff) \
                + self.n_layers * (attn_q + attn_kv + attn_o)  # cross-attn
        if self.cross_attn_every:
            blocks += (l // self.cross_attn_every) * (attn_q + attn_kv + attn_o)
        return emb + blocks

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d, l = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * (self.n_heads + 2 * self.n_kv) * self.head_dim \
            + self.n_heads * self.head_dim * d
        gl = 3
        ff_active = self.moe.top_k * gl * d * self.moe.expert_ff \
            + gl * d * self.moe.shared_ff
        return emb + l * (attn + ff_active)
