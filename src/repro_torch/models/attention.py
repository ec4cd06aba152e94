"""Attention: eager chunked flash (online softmax), GQA, RoPE, decode.

Two implementations share one signature, selected by ``cfg.attn_impl`` with
the reference's values:
  * ``"xla"`` — the port's eager flash: a Python loop over KV chunks with
    online softmax (the counterpart of the reference's ``lax.scan`` version);
  * ``"pallas"`` — the hand-written Hopper kernel behind
    ``repro_torch.kernels.ops.flash_attention`` (causal prefill).

GQA is handled by gather-expanding K/V head-wise. ``flash_attention_cv`` and
``cross_attention`` arrive with the training and encoder-decoder paths.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamBuilder, weight_matmul
from repro_torch.models.layers import apply_rope, rms_norm_vec


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def init_attention(b: ParamBuilder, *, stacked: bool = False, prefix: str = "",
                   cross: bool = False):
    cfg = b.cfg
    L = (cfg.num_layers,) if stacked else ()
    lr = ("none",) if stacked else ()
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    b.add(prefix + "wq", L + (cfg.d_model, H * hd), lr + ("d_fsdp", "qout"))
    b.add(prefix + "wk", L + (cfg.d_model, KV * hd), lr + ("d_fsdp", "kvout"))
    b.add(prefix + "wv", L + (cfg.d_model, KV * hd), lr + ("d_fsdp", "kvout"))
    b.add(prefix + "wo", L + (H * hd, cfg.d_model), lr + ("qout", "d_fsdp"))
    if cfg.use_bias:
        b.add(prefix + "bq", L + (H * hd,), lr + ("qout",), init="zeros")
        b.add(prefix + "bk", L + (KV * hd,), lr + ("kvout",), init="zeros")
        b.add(prefix + "bv", L + (KV * hd,), lr + ("kvout",), init="zeros")
        b.add(prefix + "bo", L + (cfg.d_model,), lr + ("none",), init="zeros")
    if cfg.use_qk_norm and not cross:
        b.add(prefix + "q_norm", L + (hd,), lr + ("none",), init="ones")
        b.add(prefix + "k_norm", L + (hd,), lr + ("none",), init="ones")


# ---------------------------------------------------------------------------
# projections
# ---------------------------------------------------------------------------
def _rope(cfg: ModelConfig, x, positions, use_rope: bool):
    if not use_rope:
        return x
    if cfg.mrope:
        raise NotImplementedError(
            "M-RoPE is not ported yet (ROADMAP queue A item 11, VLM)")
    return apply_rope(x, positions, cfg.rope_theta)


def q_proj(cfg: ModelConfig, p, x, positions, *, prefix: str = "",
           use_rope: bool = True):
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    q = weight_matmul(x, p[prefix + "wq"])
    if cfg.use_bias:
        q = q + p[prefix + "bq"].to(x.device, x.dtype)
    q = q.reshape(B, S, H, hd)
    if cfg.use_qk_norm:
        q = rms_norm_vec(q, p[prefix + "q_norm"], cfg.norm_eps)
    return _rope(cfg, q, positions, use_rope and not cfg.learned_pos)


def kv_proj(cfg: ModelConfig, p, x, positions, *, prefix: str = "",
            use_rope: bool = True):
    B, S, _ = x.shape
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    k = weight_matmul(x, p[prefix + "wk"])
    v = weight_matmul(x, p[prefix + "wv"])
    if cfg.use_bias:
        k = k + p[prefix + "bk"].to(x.device, x.dtype)
        v = v + p[prefix + "bv"].to(x.device, x.dtype)
    k = k.reshape(B, S, KV, hd)
    v = v.reshape(B, S, KV, hd)
    if cfg.use_qk_norm:
        k = rms_norm_vec(k, p[prefix + "k_norm"], cfg.norm_eps)
    k = _rope(cfg, k, positions, use_rope and not cfg.learned_pos)
    return k, v


def out_proj(cfg: ModelConfig, p, attn, *, prefix: str = ""):
    B, S = attn.shape[:2]
    out = weight_matmul(attn.reshape(B, S, -1), p[prefix + "wo"])
    if cfg.use_bias:
        out = out + p[prefix + "bo"].to(attn.device, attn.dtype)
    return out


def expand_kv(k, num_heads: int):
    """Gather-expand GQA KV heads to ``num_heads``."""
    KV = k.shape[2]
    if KV == num_heads:
        return k
    mapping = torch.arange(num_heads, device=k.device) // (num_heads // KV)
    return k[:, :, mapping, :]


def _kv_len_mask(kv_len, pos_k):
    """(…, Sk) validity mask from a scalar or per-row (B,) ``kv_len``,
    shaped to broadcast against (B, H, Sq, Sk) scores."""
    kvl = torch.as_tensor(kv_len, device=pos_k.device)
    if kvl.dim() == 0:
        return (pos_k < kvl)[None, None, None, :]
    return (pos_k[None, :] < kvl[:, None])[:, None, None, :]


# ---------------------------------------------------------------------------
# flash attention (loop over KV chunks, online softmax)
# ---------------------------------------------------------------------------
def flash_attention(q, k, v, *, causal: bool, q_offset=0, kv_len=None,
                    chunk: int = 1024, scale: Optional[float] = None):
    """q: (B,Sq,H,hd); k,v: (B,Sk,H,hd) (already head-expanded).

    ``q_offset``: absolute position of q[0] (decode: cache length).
    ``kv_len``: count of valid KV entries, a scalar or a (B,) vector of
    per-row lengths (the tail is masked). Rows with no valid entry stay
    finite (they come out as zeros).
    """
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    chunk = min(chunk, Sk)
    dev = q.device

    qf = (q.float() * scale).permute(0, 2, 1, 3)             # (B,H,Sq,hd)
    kt = k.permute(0, 2, 1, 3)                               # (B,H,Sk,hd)
    vt = v.permute(0, 2, 1, 3)
    pos_q = q_offset + torch.arange(Sq, device=dev)

    neg_inf = float("-inf")
    m = torch.full((B, H, Sq), neg_inf, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=dev)
    for k0 in range(0, Sk, chunk):
        kj = kt[:, :, k0:k0 + chunk].float()
        vj = vt[:, :, k0:k0 + chunk].float()
        s = qf @ kj.transpose(-1, -2)                        # (B,H,Sq,ck)
        pos_k = k0 + torch.arange(kj.shape[2], device=dev)
        mask = torch.ones((1, 1, Sq, kj.shape[2]), dtype=torch.bool, device=dev)
        if causal:
            mask = mask & (pos_q[:, None] >= pos_k[None, :])[None, None]
        if kv_len is not None:
            mask = mask & _kv_len_mask(kv_len, pos_k)
        s = torch.where(mask, s, torch.full_like(s, neg_inf))
        m_new = torch.maximum(m, s.max(dim=-1).values)
        # guard fully-masked rows (m_new = -inf): use a safe max of 0
        m_safe = torch.where(torch.isfinite(m_new), m_new,
                             torch.zeros_like(m_new))
        p = torch.exp(s - m_safe[..., None])
        p = torch.where(mask, p, torch.zeros_like(p))
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                           torch.zeros_like(m))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + p @ vj
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)               # (B,Sq,H,hd)


def decode_attention(q, k, v, *, kv_len=None, scale: Optional[float] = None):
    """Single-pass attention for Sq == 1 over the whole cache.

    q: (B,Sq,H,hd); k, v: (B,Sk,KV,hd) with KV dividing H — GQA groups are
    contracted directly, which equals attending over head-expanded K/V
    without materialising the expansion. ``q`` may be fp32 while the cache
    is bf16 (the pool's dtype): the scaled query is rounded to ``q.dtype``
    and the probabilities to ``v.dtype``, as the reference's mixed-precision
    products see them, and both products are taken in fp32.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    qg = qs.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())     # (B,KV,G,Sq,Sk)
    if kv_len is not None:
        mask = _kv_len_mask(kv_len, torch.arange(Sk, device=q.device))
        s = s.masked_fill(~mask[:, :, None], float("-inf"))
    p = torch.softmax(s, dim=-1).to(v.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def attention_core(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset=0,
                   kv_len=None):
    """Dispatch on ``cfg.attn_impl``; GQA heads are expanded for the flash
    paths and contracted in groups by ``decode_attention``."""
    if q.shape[1] == 1 and not causal:
        return decode_attention(q, k, v, kv_len=kv_len)
    k = expand_kv(k, cfg.num_heads)
    v = expand_kv(v, cfg.num_heads)
    if cfg.attn_impl == "pallas" and causal and q.shape[1] == k.shape[1]:
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=True)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, chunk=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# full layer applications
# ---------------------------------------------------------------------------
def self_attention(cfg: ModelConfig, p, x, positions, *, causal: bool = True,
                   prefix: str = "") -> Tuple[torch.Tensor, Tuple]:
    """Prefill self-attention. Returns (out, (k, v)) for caching."""
    q = q_proj(cfg, p, x, positions, prefix=prefix)
    k, v = kv_proj(cfg, p, x, positions, prefix=prefix)
    attn = attention_core(cfg, q, k, v, causal=causal)
    return out_proj(cfg, p, attn, prefix=prefix), (k, v)


def decode_self_attention(cfg: ModelConfig, p, x, cache_k, cache_v, cache_pos,
                          positions, *, prefix: str = ""):
    """Single-token decode: insert new KV at ``cache_pos``, attend over cache.

    cache_k/v: (B, S_max, KV, hd). ``cache_pos`` is a scalar, or a (B,)
    vector of per-row positions (ragged continuous batching). The cache is
    updated **in place** (the reference returns new arrays); the same tensors
    are returned as (out, cache_k, cache_v).
    """
    q = q_proj(cfg, p, x, positions, prefix=prefix)
    k_new, v_new = kv_proj(cfg, p, x, positions, prefix=prefix)
    pos = torch.as_tensor(cache_pos, device=x.device).long()
    if pos.dim() == 0:
        idx = pos + torch.arange(x.shape[1], device=x.device)
        cache_k.index_copy_(1, idx, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, idx, v_new.to(cache_v.dtype))
    else:  # per-row scatter (Sq == 1)
        rows = torch.arange(cache_k.shape[0], device=x.device)
        cache_k[rows, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v_new[:, 0].to(cache_v.dtype)
    attn = attention_core(cfg, q, cache_k, cache_v, causal=False,
                          kv_len=pos + x.shape[1])
    return out_proj(cfg, p, attn, prefix=prefix), cache_k, cache_v
