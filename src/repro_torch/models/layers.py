"""Shared neural blocks: norms, RoPE, MLPs, embeddings.

Counterparts of ``repro/models/layers.py``; ``apply_mrope`` arrives with the
VLM family. Weights are cast to the activation dtype at each use, as the
reference does, and may live in either tier of an offload plan: products go
through ``weight_matmul``, small leaves (norm scales, biases) are moved to
the activations' device at use, and embedding rows of a host-tier table are
gathered on the host.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamBuilder, cdtype, weight_matmul


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
def init_norm(b: ParamBuilder, name: str, dim_role: str = "none",
              *, stacked: bool = False):
    cfg = b.cfg
    L = (cfg.num_layers,) if stacked else ()
    lr = ("none",) if stacked else ()
    b.add(f"{name}_scale", L + (cfg.d_model,), lr + (dim_role,), init="ones")
    if cfg.norm == "layernorm":
        b.add(f"{name}_bias", L + (cfg.d_model,), lr + (dim_role,), init="zeros")


def apply_norm(cfg: ModelConfig, p, name: str, x):
    """RMSNorm or LayerNorm over the last dim, fp32 inside."""
    scale = p[f"{name}_scale"].to(x.device, torch.float32)
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * scale + p[f"{name}_bias"].to(x.device, torch.float32)
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * scale
    return y.to(x.dtype)


def rms_norm_vec(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim with an explicit scale vector."""
    xf = x.float()
    ms = xf.square().mean(dim=-1, keepdim=True)
    scale = scale.to(x.device, torch.float32)
    return (xf * torch.rsqrt(ms + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * freqs              # (..., S, hd/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU or plain 2-matmul)
# ---------------------------------------------------------------------------
def init_mlp(b: ParamBuilder, stacked: bool = False):
    cfg = b.cfg
    L = (cfg.num_layers,) if stacked else ()
    lr = ("none",) if stacked else ()
    b.add("w_in", L + (cfg.d_model, cfg.d_ff), lr + ("d_fsdp", "ffn"))
    if cfg.glu:
        b.add("w_gate", L + (cfg.d_model, cfg.d_ff), lr + ("d_fsdp", "ffn"))
    b.add("w_out", L + (cfg.d_ff, cfg.d_model), lr + ("ffn", "d_fsdp"))
    if cfg.use_bias:
        b.add("b_in", L + (cfg.d_ff,), lr + ("ffn",), init="zeros")
        if cfg.glu:
            b.add("b_gate", L + (cfg.d_ff,), lr + ("ffn",), init="zeros")
        b.add("b_out", L + (cfg.d_model,), lr + ("none",), init="zeros")


def _act(cfg: ModelConfig, x):
    # the reference's gelu is the tanh approximation (jax.nn.gelu's default)
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def apply_mlp(cfg: ModelConfig, p, x):
    h = weight_matmul(x, p["w_in"])
    if cfg.use_bias:
        h = h + p["b_in"].to(x.device, x.dtype)
    if cfg.glu:
        g = weight_matmul(x, p["w_gate"])
        if cfg.use_bias:
            g = g + p["b_gate"].to(x.device, x.dtype)
        h = _act(cfg, g) * h
    else:
        h = _act(cfg, h)
    out = weight_matmul(h, p["w_out"])
    if cfg.use_bias:
        out = out + p["b_out"].to(x.device, x.dtype)
    return out


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------
def init_embeddings(b: ParamBuilder):
    cfg = b.cfg
    b.add("tok_embed", (cfg.vocab_size, cfg.d_model), ("vocab", "d_fsdp"), scale=0.02)
    if cfg.learned_pos:
        b.add("pos_embed", (cfg.max_position, cfg.d_model), ("none", "d_fsdp"),
              scale=0.02)
    init_norm(b, "final_norm")
    if not cfg.tie_embeddings:
        b.add("lm_head", (cfg.d_model, cfg.vocab_size), ("d_fsdp", "vocab"))


def gather_rows(table, idx):
    """``table[idx]`` on idx's device, in the table's dtype. A host-tier
    table beside CUDA indices is gathered on the host and only the rows
    cross the link (the row traffic the planner prices an embedding spill
    at); ``gather_rows.h2d_bytes`` counts them."""
    if table.device == idx.device:
        return table[idx]
    rows = table[idx.cpu()]
    gather_rows.h2d_bytes += rows.numel() * rows.element_size()
    return rows.to(idx.device)


gather_rows.h2d_bytes = 0


def embed_tokens(cfg: ModelConfig, p, tokens,
                 positions: Optional[torch.Tensor] = None):
    """Rows are gathered in the parameter dtype, then cast."""
    x = gather_rows(p["tok_embed"], tokens).to(cdtype(cfg))
    if cfg.learned_pos:
        if positions is None:
            positions = torch.arange(tokens.shape[-1],
                                     device=tokens.device)[None, :]
        x = x + gather_rows(p["pos_embed"], positions).to(x.dtype)
    return x


def unembed(cfg: ModelConfig, p, x):
    x = apply_norm(cfg, p, "final_norm", x)
    w = p["tok_embed"].T if cfg.tie_embeddings else p["lm_head"]
    return weight_matmul(x, w)
