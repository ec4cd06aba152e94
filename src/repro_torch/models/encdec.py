"""Whisper-style encoder-decoder backbone (the reference's
``repro/models/encdec.py``).

The audio conv frontend is a stub, as in the reference: inputs are
precomputed frame embeddings (batch, encoder_seq, d_model). The encoder runs
bidirectional self-attention; the decoder runs causal self-attention, then
cross-attention over the encoder output, then the MLP. Each decoder layer's
cross K/V are projected from the encoder output once, at the prefill, and
kept in the cache beside the self-attention K/V:
``{"k", "v"}`` (L, B, max_seq, KV, hd) and ``{"cross_k", "cross_v"}``
(L, B, encoder_seq, KV, hd). A ``KVPool`` holds the cross leaves whole,
whatever its ``max_seq`` (they are no sequence leaves of the pool).

The reference scans over stacked layer parameters; here a Python loop
indexes the same stacked tensors, and every product goes through
``weight_matmul`` as in the other families. The decode updates the
self-attention cache in place and returns the cross leaves unchanged; its
``pos`` may be a scalar or one cache length per row. The reference's
``cache_specs_encdec`` is a sharding spec with no single-device counterpart
and is not ported.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models.common import (AxisEnv, ParamBuilder, ShardingPolicy,
                                       cdtype, pspec, to_dtype)
from repro_torch.models.transformer import (_embed_input, _layer_params,
                                            remat_wrap)

PyTree = Any


def init_encdec(cfg: ModelConfig, generator: Optional[torch.Generator],
                device: torch.device, *, abstract: bool = False,
                placement: Optional[Dict[str, str]] = None,
                pol: Optional[ShardingPolicy] = None,
                env: Optional[AxisEnv] = None
                ) -> Tuple[PyTree, PyTree]:
    """(params, specs): the token table and unembedding, ``enc_pos_embed``
    (encoder_seq, d_model), and the ``encoder`` (stacked over
    ``encoder_layers``, plus the unstacked ``enc_final`` norm) and
    ``decoder`` (stacked over ``num_layers``, with ``cross_*`` attention)
    children."""
    b = ParamBuilder(cfg, generator, device, abstract=abstract,
                     placement=placement, pol=pol, env=env)
    nn.init_embeddings(b)
    b.add("enc_pos_embed", (cfg.encoder_seq, cfg.d_model), ("none", "d_fsdp"),
          scale=0.02)

    eb = b.child("encoder")
    eb.cfg = cfg.with_(num_layers=cfg.encoder_layers)
    attn.init_attention(eb, stacked=True)
    nn.init_mlp(eb, stacked=True)
    nn.init_norm(eb, "norm1", stacked=True)
    nn.init_norm(eb, "norm2", stacked=True)
    nn.init_norm(eb, "enc_final")

    db = b.child("decoder")
    attn.init_attention(db, stacked=True)
    attn.init_attention(db, stacked=True, prefix="cross_", cross=True)
    nn.init_mlp(db, stacked=True)
    nn.init_norm(db, "norm1", stacked=True)
    nn.init_norm(db, "norm2", stacked=True)
    nn.init_norm(db, "norm3", stacked=True)
    return b.params, b.specs


def encode(cfg: ModelConfig, params, frames):
    """frames: (B, enc_seq, D) precomputed embeddings -> (B, enc_seq, D)."""
    x = frames.to(cdtype(cfg))
    x = x + params["enc_pos_embed"][: x.shape[1]].to(x.device, x.dtype)[None]
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    ecfg = cfg.with_(num_layers=cfg.encoder_layers)
    ep = params["encoder"]
    stacked = {k: w for k, w in ep.items() if not k.startswith("enc_final")}
    for i in range(cfg.encoder_layers):
        lp = _layer_params(stacked, i)

        def body(x, lp=lp):
            h = nn.apply_norm(ecfg, lp, "norm1", x)
            a, _ = attn.self_attention(ecfg, lp, h, positions, causal=False)
            x = x + a
            return x + nn.apply_mlp(ecfg, lp, nn.apply_norm(ecfg, lp, "norm2", x))
        x = remat_wrap(cfg, body)(x)
    return nn.apply_norm(ecfg, ep, "enc_final", x)


def _dec_layer(cfg: ModelConfig, lp, x, positions, enc_k, enc_v, cache=None,
               cache_pos=None):
    """Self-attention (prefill, or decode against ``cache`` = (k, v) written
    in place at ``cache_pos``), cross-attention, MLP; three pre-norms.
    Returns (x, (k, v))."""
    h = nn.apply_norm(cfg, lp, "norm1", x)
    if cache is None:
        a, kv = attn.self_attention(cfg, lp, h, positions)
    else:
        ck, cv = cache
        a, ck, cv = attn.decode_self_attention(cfg, lp, h, ck, cv, cache_pos,
                                               positions)
        kv = (ck, cv)
    x = x + a
    h = nn.apply_norm(cfg, lp, "norm2", x)
    x = x + attn.cross_attention(cfg, lp, h, enc_k, enc_v)
    x = x + nn.apply_mlp(cfg, lp, nn.apply_norm(cfg, lp, "norm3", x))
    return x, kv


def forward_encdec(cfg: ModelConfig, params, batch, *,
                   return_cache: bool = False, last_token_only: bool = False):
    """Teacher-forced training / prefill over ``frames`` + ``tokens``.
    Returns (logits, aux (zero), cache_or_None)."""
    enc_out = encode(cfg, params, batch["frames"])
    x, positions = _embed_input(cfg, params, {"tokens": batch["tokens"]})
    dp = params["decoder"]
    caches = []
    for i in range(cfg.num_layers):
        lp = _layer_params(dp, i)

        def body(x, lp=lp):
            ek, ev = attn.kv_proj(cfg, lp, enc_out, None, prefix="cross_",
                                  use_rope=False)
            x, (k, v) = _dec_layer(cfg, lp, x, positions, ek, ev)
            return x, (k, v, ek, ev)
        x, kvs = remat_wrap(cfg, body)(x)
        if return_cache:
            caches.append(kvs)
    cache = None
    if return_cache:
        cache = {name: torch.stack([c[j] for c in caches])
                 for j, name in enumerate(("k", "v", "cross_k", "cross_v"))}
    if last_token_only:
        x = x[:, -1:, :]
    logits = nn.unembed(cfg, params, x)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device), cache


def decode_encdec(cfg: ModelConfig, params, cache, batch):
    """One-token decode against the cached self K/V (updated **in place**)
    and cross K/V (read only). Returns (logits (B, V), cache)."""
    x, positions = _embed_input(cfg, params, batch)
    dp = params["decoder"]
    for i in range(cfg.num_layers):
        x, _ = _dec_layer(cfg, _layer_params(dp, i), x, positions,
                          cache["cross_k"][i], cache["cross_v"][i],
                          cache=(cache["k"][i], cache["v"][i]),
                          cache_pos=batch["pos"])
    logits = nn.unembed(cfg, params, x[:, 0:1, :])[:, 0, :]
    return logits, cache


def init_cache_encdec(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, device=None) -> PyTree:
    dtype = to_dtype(dtype)

    def zeros(seq):
        return torch.zeros((cfg.num_layers, batch, seq, cfg.num_kv_heads,
                            cfg.head_dim), dtype=dtype, device=device)
    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "cross_k": zeros(cfg.encoder_seq), "cross_v": zeros(cfg.encoder_seq)}


def cache_specs_encdec(cfg: ModelConfig, batch: int, env: AxisEnv,
                       pol: ShardingPolicy) -> PyTree:
    """The reference's specs of ``init_cache_encdec``'s tree: self-attention
    K/V with the sequence on the model axis, the cross K/V whole over it
    (1500 frames are not divisible by it). Specs only: enc-dec execution on
    a mesh is ROADMAP A28."""
    baxes = env.batch_axes(batch)
    kv = pspec(None, baxes, env.tp, None, None)
    cross = pspec(None, baxes, None, None, None)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
