"""Attention: eager chunked flash (online softmax), GQA, RoPE, decode.

Three implementations share one signature, selected by ``cfg.attn_impl`` with
the reference's values:
  * ``"xla"`` — the port's eager flash: a Python loop over KV chunks with
    online softmax (the counterpart of the reference's ``lax.scan`` version),
    differentiated by autograd;
  * ``"xla_cv"`` — ``flash_attention_cv``, the reference's custom-VJP flash:
    a ``torch.autograd.Function`` whose forward is the hand-written forward
    kernel with its ``lse`` output and whose backward is the two hand-written
    backward kernels (the training path);
  * ``"pallas"`` — the hand-written forward kernel behind
    ``repro_torch.kernels.ops.flash_attention`` (causal prefill). It has no
    backward, as in the reference, and raises under autograd.

On a mesh each rank attends with its local query heads on its local
tensors: the flash kernels launch at the local shape (``expand_kv``'s
``group`` / ``head_offset`` pick the KV heads of the local query heads when
the KV heads are whole on every rank), and ``decode_attention`` reads the
rank's part of a sequence-split cache, the parts' softmax stats combined
over the model axis (``model_group``).

GQA is handled by gather-expanding K/V head-wise. ``cross_attention`` (the
encoder-decoder's) is not causal, so like the encoder's self-attention it
takes the eager flash whatever ``attn_impl`` says, as in the reference, whose
kernel route is for causal self-attention only.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa_kernels
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamBuilder, weight_matmul
from repro_torch.models.layers import apply_mrope, apply_rope, rms_norm_vec


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
        return apply_mrope(x, positions, cfg.rope_theta)
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


def out_proj(cfg: ModelConfig, p, attn, *, prefix: str = "",
             bias: bool = True):
    """``bias=False`` leaves ``bo`` out: on a mesh each model rank's product
    is a partial sum, and the bias is added once after their all-reduce."""
    B, S, H, hd = attn.shape
    out = weight_matmul(attn.reshape(B, S, H * hd), p[prefix + "wo"])
    if cfg.use_bias and bias:
        out = out + p[prefix + "bo"].to(attn.device, attn.dtype)
    return out


def expand_kv(k, num_heads: int, *, group: Optional[int] = None,
              head_offset: int = 0):
    """Gather-expand GQA KV heads to ``num_heads``: query head ``j`` reads
    KV head ``j // group`` (``group`` = heads / KV heads by default).

    On a mesh whose model axis does not divide the KV heads, the KV heads
    stay whole on every rank (replicated) while the query heads are split:
    local head ``j`` of model rank ``r`` is global head ``head_offset + j``
    (``head_offset = r x local heads``), and reads global KV head
    ``(head_offset + j) // group``, not the first local ones."""
    KV = k.shape[2]
    if group is None:
        if KV == num_heads:
            return k
        group = num_heads // KV
    mapping = (head_offset + torch.arange(num_heads, device=k.device)) // group
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


def decode_attention(q, k, v, *, kv_len=None, scale: Optional[float] = None,
                     k_offset: int = 0, model_group=None):
    """Single-pass attention for Sq == 1 over the whole cache.

    q: (B,Sq,H,hd); k, v: (B,Sk,KV,hd) with KV dividing H — GQA groups are
    contracted directly, which equals attending over head-expanded K/V
    without materialising the expansion. ``q`` may be fp32 while the cache
    is bf16 (the pool's dtype): the scaled query is rounded to ``q.dtype``
    and the probabilities to ``v.dtype``, as the reference's mixed-precision
    products see them, and both products are taken in fp32.

    On a mesh whose model axis splits the cache's sequence
    (``model_group``), ``k`` and ``v`` are this rank's part, whose first
    entry is global position ``k_offset`` (``kv_len`` counts global
    positions), and ``q`` holds the heads of every rank: each rank takes its
    softmax max and weighted sum over its positions and the ranks combine
    them (all-reduce of the max, then of the rescaled sums), as the
    reference's GSPMD reduces an S-sharded single-pass decode.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else hd ** -0.5
    qs = (q.float() * scale).to(q.dtype)
    qg = qs.float().reshape(B, Sq, KV, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float())     # (B,KV,G,Sq,Sk)
    if kv_len is not None:
        mask = _kv_len_mask(kv_len,
                            k_offset + torch.arange(Sk, device=q.device))
        s = s.masked_fill(~mask[:, :, None], float("-inf"))
    if model_group is None:
        p = torch.softmax(s, dim=-1).to(v.dtype)
        out = torch.einsum("bkgqs,bskd->bqkgd", p.float(), v.float())
        return out.reshape(B, Sq, H, hd).to(q.dtype)
    from torch.distributed import _functional_collectives as funcol
    m = funcol.all_reduce(s.amax(dim=-1), "max", model_group)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    l = funcol.all_reduce(p.sum(dim=-1), "sum", model_group)
    acc = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    acc = funcol.all_reduce(acc, "sum", model_group)
    out = acc / l.permute(0, 3, 1, 2).clamp_min(1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention with a custom backward (the reference's custom VJP)
#
# The reference's ``flash_attention_cv`` saves only the (B, H, Sq) logsumexp
# stats and recomputes p per chunk in the backward. Here the forward is the
# hand-written kernel with its ``lse`` output and the backward the two
# hand-written backward kernels; on CPU tensors both take their plain
# versions, the same arithmetic in PyTorch.
# ---------------------------------------------------------------------------
def _fold(t):
    """(B, S, H, hd) -> contiguous (B*H, S, hd), heads into the batch dim."""
    B, S, H, hd = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, S, hd).contiguous()


def _unfold(t, B: int, H: int):
    """(B*H, S, hd) -> (B, S, H, hd)."""
    return t.reshape(B, H, t.shape[1], t.shape[2]).permute(0, 2, 1, 3)


class _FlashCV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float, q_offset: int):
        B, H = q.shape[0], q.shape[2]
        qf, kf, vf = _fold(q), _fold(k), _fold(v)
        out, lse = fa_kernels.flash_attention_fwd_stats(qf, kf, vf,
                                                        causal=causal,
                                                        scale=scale,
                                                        q_offset=q_offset)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.causal, ctx.scale, ctx.heads = causal, scale, (B, H)
        ctx.q_offset = q_offset
        return _unfold(out, B, H).contiguous()

    @staticmethod
    def backward(ctx, dout):
        qf, kf, vf, out, lse = ctx.saved_tensors
        B, H = ctx.heads
        dq, dk, dv = fa_kernels.flash_attention_bwd(
            qf, kf, vf, out, lse, _fold(dout), causal=ctx.causal,
            scale=ctx.scale, q_offset=ctx.q_offset)
        return (_unfold(dq, B, H), _unfold(dk, B, H), _unfold(dv, B, H),
                None, None, None)


def flash_attention_cv(q, k, v, causal: bool, chunk: int, scale: float,
                       q_offset: int = 0):
    """q: (B,Sq,H,hd); k, v: (B,Sk,H,hd) (head-expanded). Differentiable
    flash attention through the kernels; ``q_offset`` the causal mask's
    position of query row 0 (a sequence-parallel rank's first token).
    ``chunk`` is kept for the reference's signature: it sizes the
    reference's scan and selects this route in ``attention_core``; the
    kernels choose their own tiles."""
    del chunk
    return _FlashCV.apply(q, k, v, causal, scale, q_offset)


def attention_core(cfg: ModelConfig, q, k, v, *, causal: bool, q_offset=0,
                   kv_len=None, kv_group: Optional[int] = None,
                   head_offset: int = 0):
    """Dispatch on ``cfg.attn_impl``; GQA heads are expanded for the flash
    paths and contracted in groups by ``decode_attention``. ``kv_group`` and
    ``head_offset``: ``expand_kv``'s, for local heads on a mesh.
    ``q_offset``: the position of query row 0 under the causal mask; a
    sequence-parallel rank attends its block of queries at its first
    position over the whole sequence's keys (``Sk = S``), and both kernel
    routes take the offset (the kernels never read a key past the last
    query's position). The pallas route (forward kernel) takes a causal call
    whose queries all lie within the keys, ``Sq + q_offset <= Sk``: the
    reference's ``Sq == Sk`` at no offset. A single query that is not
    causal (a decode step's cross attention) contracts the GQA groups in
    ``decode_attention``, after ``expand_kv`` where ``kv_group`` maps local
    query heads into whole KV heads."""
    if q.shape[1] == 1 and not causal:
        if kv_group is not None:
            k = expand_kv(k, q.shape[2], group=kv_group, head_offset=head_offset)
            v = expand_kv(v, q.shape[2], group=kv_group, head_offset=head_offset)
        return decode_attention(q, k, v, kv_len=kv_len)
    k = expand_kv(k, q.shape[2], group=kv_group, head_offset=head_offset)
    v = expand_kv(v, q.shape[2], group=kv_group, head_offset=head_offset)
    if not q.shape[1]:
        # no queries (a sequence-parallel rank's block of a prompt shorter
        # than the model axis): nothing to launch, the eager route's empty
        # products keep the keys and values in the graph
        return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                               kv_len=kv_len, chunk=cfg.attn_chunk)
    if (cfg.attn_impl == "pallas" and causal
            and q.shape[1] + q_offset <= k.shape[1]):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise RuntimeError(
                "attn_impl='pallas' is the forward kernel alone and has no "
                "backward (the reference cannot differentiate it either); "
                "train with attn_impl='xla_cv'")
        return kops.flash_attention(q, k, v, causal=True, q_offset=q_offset)
    if (cfg.attn_impl == "xla_cv" and causal and kv_len is None
            and k.shape[1] % min(cfg.attn_chunk, k.shape[1]) == 0):
        return flash_attention_cv(q, k, v, True, cfg.attn_chunk,
                                  cfg.head_dim ** -0.5, q_offset)
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           kv_len=kv_len, chunk=cfg.attn_chunk)


# ---------------------------------------------------------------------------
# full layer applications
# ---------------------------------------------------------------------------
def cache_attend(cfg: ModelConfig, q, k_new, v_new, cache_k, cache_v,
                 cache_pos):
    """Writes ``k_new`` / ``v_new`` into the cache **in place** at
    ``cache_pos`` (a scalar, or a (B,) vector with Sq == 1) and attends
    ``q`` over the cache's valid entries."""
    Sq = q.shape[1]
    pos = torch.as_tensor(cache_pos, device=q.device).long()
    if pos.dim() == 0:
        idx = pos + torch.arange(Sq, device=q.device)
        cache_k.index_copy_(1, idx, k_new.to(cache_k.dtype))
        cache_v.index_copy_(1, idx, v_new.to(cache_v.dtype))
    else:  # per-row scatter (Sq == 1)
        rows = torch.arange(cache_k.shape[0], device=q.device)
        cache_k[rows, pos] = k_new[:, 0].to(cache_k.dtype)
        cache_v[rows, pos] = v_new[:, 0].to(cache_v.dtype)
    return attention_core(cfg, q, cache_k, cache_v, causal=False,
                          kv_len=pos + Sq)


def cross_attention(cfg: ModelConfig, p, x, enc_k, enc_v, *,
                    prefix: str = "cross_", bias: bool = True,
                    kv_group: Optional[int] = None, head_offset: int = 0):
    """Decoder cross-attention over precomputed encoder K/V (no mask, no
    rope): (B, S, D) queries against (B, S_enc, KV, hd) keys and values.
    ``bias``: as ``out_proj``'s; ``kv_group`` / ``head_offset``:
    ``expand_kv``'s, for local query heads over whole KV heads."""
    q = q_proj(cfg, p, x, None, prefix=prefix, use_rope=False)
    attn = attention_core(cfg, q, enc_k, enc_v, causal=False,
                          kv_group=kv_group, head_offset=head_offset)
    return out_proj(cfg, p, attn, prefix=prefix, bias=bias)
