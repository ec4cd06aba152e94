"""Model configuration schema for every architecture in the zoo.

A single frozen dataclass covers all families (dense / MoE / SSM / hybrid /
enc-dec / VLM); family-specific fields are zero / empty when unused. Each
architecture file under ``repro_torch/configs`` exports ``CONFIG`` built from public
literature numbers (sources quoted in the assignment).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional

DENSE = "dense"
MOE = "moe"
SSM = "ssm"
HYBRID = "hybrid"
ENCDEC = "encdec"
VLM = "vlm"

FAMILIES = (DENSE, MOE, SSM, HYBRID, ENCDEC, VLM)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 8192  # split long sequences into routing sub-groups

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 256

    # --- hybrid (Zamba2-style): shared attention block every N SSM layers ---
    attn_every: int = 0

    # --- encoder-decoder (Whisper backbone) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # precomputed frame embeddings (conv frontend stub)

    # --- architectural switches ---
    use_qk_norm: bool = False
    use_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    mrope: bool = False  # Qwen2-VL multimodal RoPE (3 position streams)
    learned_pos: bool = False  # GPT-2 / Whisper style absolute positions
    max_position: int = 1 << 20
    norm: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    norm_eps: float = 1e-5
    act: str = "silu"
    glu: bool = True  # SwiGLU (gated) vs plain 2-matmul MLP

    # --- numerics / runtime knobs (not architecture) ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: str = "layer"  # "none" | "layer" | "full" | "offload"
    # Megatron-style sequence parallelism for the residual stream: layer
    # boundaries are S-sharded over "model" (divides saved activations by the
    # model-axis size at the cost of per-layer gather/scatter collectives).
    seq_shard_residuals: bool = False
    # the reference's values, so one config drives both packages: "xla" is
    # the eager chunked flash here, "pallas" the hand-written CUDA kernel
    attn_impl: str = "xla"
    attn_chunk: int = 1024  # KV-block size for the chunked flash attention

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # ------------------------------------------------------------------
    @property
    def is_attention_free(self) -> bool:
        return self.family == SSM

    @property
    def subquadratic(self) -> bool:
        """True if long-context decode (500k) is feasible: SSM or hybrid."""
        return self.family in (SSM, HYBRID)

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decoder

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Total parameters (analytic; verified against init in tests)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim or 0
        qkv = d * (self.num_heads * hd) + 2 * d * (self.num_kv_heads * hd)
        proj = (self.num_heads * hd) * d
        attn = qkv + proj
        if self.use_qk_norm:
            attn += 2 * hd
        if self.glu:
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.use_bias:
            attn += (self.num_heads + 2 * self.num_kv_heads) * hd + d
            mlp += (f + d) if not self.glu else (2 * f + d)
        norms = 2 * d

        if self.family == MOE:
            router = d * self.num_experts
            block = attn + norms + router + self.num_experts * mlp
            total = self.num_layers * block
        elif self.family == SSM:
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)  # z, x, B, C, dt
            conv = self.conv_width * (di + 2 * ns)
            out_proj = di * d
            block = in_proj + conv + out_proj + d + di + 2 * nh  # norms+A,dt_bias
            total = self.num_layers * block
        elif self.family == HYBRID:
            di, ns = self.d_inner, self.ssm_state
            nh = self.ssm_heads
            in_proj = d * (2 * di + 2 * ns + nh)
            conv = self.conv_width * (di + 2 * ns)
            out_proj = di * d
            mblock = in_proj + conv + out_proj + d + di + 2 * nh
            shared = attn + mlp + norms  # one shared attention+MLP block
            total = self.num_layers * mblock + shared
        elif self.family == ENCDEC:
            # encoder: self-attn + mlp; decoder: self-attn + cross-attn + mlp
            enc_block = attn + mlp + norms
            dec_block = 2 * attn + mlp + 3 * d
            total = self.encoder_layers * enc_block + self.num_layers * dec_block
            if self.learned_pos:
                total += (self.encoder_seq + self.max_position) * d
        else:  # dense / vlm
            block = attn + mlp + norms
            total = self.num_layers * block
        total += v * d  # token embedding
        if not self.tie_embeddings:
            total += v * d  # output head
        total += d  # final norm
        if self.learned_pos and self.family != ENCDEC:
            total += self.max_position * d
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE activates top-k experts only)."""
        if self.family != MOE:
            return self.param_count()
        full = self.param_count()
        mlp = (3 if self.glu else 2) * self.d_model * self.d_ff
        inactive = self.num_layers * (self.num_experts - self.experts_per_token) * mlp
        return full - inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kv = max(1, min(self.num_kv_heads, 2))
        heads = max(kv, min(self.num_heads, 4))
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=64,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=16,
            d_ff=min(self.d_ff, 128) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            max_position=4096 if self.learned_pos else self.max_position,
            attn_chunk=64,
        )
        if self.family == MOE:
            changes.update(num_experts=min(self.num_experts, 4),
                           experts_per_token=min(self.experts_per_token, 2))
        if self.family in (SSM, HYBRID):
            changes.update(ssm_state=min(self.ssm_state, 16), ssm_head_dim=16,
                           ssm_chunk=32)
        if self.family == HYBRID:
            changes.update(num_layers=4, attn_every=2)
        if self.family == ENCDEC:
            changes.update(encoder_layers=min(self.encoder_layers, 2),
                           encoder_seq=min(self.encoder_seq, 32))
        return replace(self, **changes)

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)
