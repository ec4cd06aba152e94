"""Shared neural blocks: norms, RoPE, MLPs, embeddings.

Counterparts of ``repro/models/layers.py``, Qwen2-VL's M-RoPE included.
Weights are cast to the activation dtype at each use, as the reference does,
and may live in either tier of an offload plan: products go through
``weight_matmul``, small leaves (norm scales, biases) are moved to the
activations' device at use, and embedding rows of a host-tier table are
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


def _rotate(x, ang):
    """Rotate the two halves of x's last dim by ``ang`` (..., S, hd/2), fp32
    inside, the result in x's dtype."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)        # (hd/2,)
    return _rotate(x, positions[..., None].float() * freqs)


def apply_mrope(x, positions_thw, theta: float, sections=(2, 3, 3)):
    """Qwen2-VL multimodal RoPE. x: (B, S, H, hd); positions_thw: (3, B, S),
    the temporal / height / width position streams.

    The hd/2 frequency dims are split into three contiguous groups in the
    ratio ``sections`` (16:24:24 at hd 128), each rotated by its own stream.
    """
    half = x.shape[-1] // 2
    total, acc, starts = sum(sections), 0, []
    for s in sections:
        starts.append(half * acc // total)
        acc += s
    dims = torch.arange(half, device=x.device)
    stream = (dims[None, :] >= torch.tensor(starts, device=x.device)[:, None]
              ).sum(dim=0) - 1                              # (hd/2,) in 0..2
    pos = positions_thw.to(x.device).index_select(0, stream).movedim(0, -1)
    return _rotate(x, pos.float() * rope_freqs(x.shape[-1], theta, x.device))


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


def silu(x):
    """``jax.nn.silu`` as the reference computes it: for bf16 and fp16 inputs
    ``x * (1 / (1 + exp(-x)))`` with every step rounded to the input's dtype
    (XLA's low-precision logistic, then the product), which ``F.silu``
    (rounded once) misses in about a third of bf16 values. fp32 keeps
    ``F.silu``."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x * (1 / (1 + torch.exp(-x)))
    return F.silu(x)


def _act(cfg: ModelConfig, x):
    # the reference's gelu is the tanh approximation (jax.nn.gelu's default)
    return F.gelu(x, approximate="tanh") if cfg.act == "gelu" else F.silu(x)


def apply_mlp(cfg: ModelConfig, p, x, *, out_bias: bool = True):
    """``out_bias=False`` leaves ``b_out`` out, for a mesh's partial sums
    (added once after their all-reduce)."""
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
    if cfg.use_bias and out_bias:
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


def take_rows(table, idx):
    """``jnp.take(table, idx, axis=0)`` as the reference calls it (JAX's
    default "fill" mode): an index past the table's rows reads a row of NaN
    (gpt2-124m's 1024 learned positions at a 4096-token step), where
    ``table[idx]`` would raise."""
    n = table.shape[0]
    rows = gather_rows(table, idx.clamp(max=n - 1))
    return torch.where((idx < n)[..., None], rows,
                       torch.full((), float("nan"), dtype=rows.dtype,
                                  device=rows.device))


def embed_tokens(cfg: ModelConfig, p, tokens,
                 positions: Optional[torch.Tensor] = None):
    """Rows are gathered in the parameter dtype, then cast."""
    x = gather_rows(p["tok_embed"], tokens).to(cdtype(cfg))
    if cfg.learned_pos:
        if positions is None:
            positions = torch.arange(tokens.shape[-1],
                                     device=tokens.device)[None, :]
        x = x + take_rows(p["pos_embed"], positions).to(x.dtype)
    return x


def unembed(cfg: ModelConfig, p, x, seq_shard=None):
    """Final norm, then the (tied or own) head. ``seq_shard`` (on a mesh):
    a function that lays the normed activations out for the head, applied
    whenever given: when the vocab dim cannot be model-sharded, a split of
    their TOKEN dim over the model axis, as the reference's
    ``with_sharding_constraint`` there (the loss is per token, so this is
    communication-free and caps the (B, S, V) fp32 buffer at 1 / model-axis
    per device); with the vocab model-sharded, the entry of the
    tensor-parallel region."""
    x = apply_norm(cfg, p, "final_norm", x)
    if seq_shard is not None:
        x = seq_shard(x)
    w = p["tok_embed"].T if cfg.tie_embeddings else p["lm_head"]
    return weight_matmul(x, w)


def softmax_xent(logits, labels) -> torch.Tensor:
    """Mean token cross-entropy, fp32 inside. The reference contracts the
    logits with a one-hot of the labels, a form that stays local when the
    vocabulary is sharded; on one device a gather of the label's logit is the
    same value without materialising the (B, S, V) one-hot."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()
