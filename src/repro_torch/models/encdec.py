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
``pos`` may be a scalar or one cache length per row.

The encoder's layers are ``transformer``'s attention + MLP block
(bidirectional), the decoder's its attention and MLP blocks around a cross
attention block, and both call the hooks of ``transformer.OneDevice`` or, on
a mesh, ``MeshRun``, in both layouts the reference's policy gives:

* where the model axis does not divide the heads (whisper's 20 on 16 or 8),
  the frames and the decoder's tokens are split by sequence over it
  (sequence-parallel attention: the encoder gathers each layer's K/V, the
  decoder its self-attention K/V and its cross K/V from the local frames);
* where it does (2, 4, 5, 10, 20), the heads and the MLP width are split
  over it (Megatron): the frames are whole on every model rank, and each
  layer's cross K/V are projected from the encoder's output inside the
  tensor-parallel region (entered once, its backward summing the ranks'
  parts), each rank's KV heads where the axis splits them, else all of
  them, read by the local query heads through ``kv_group``.

The cache is laid out by ``cache_specs_encdec`` in both: the self K/V split
by sequence over the model axis whatever the heads do, the cross K/V whole
over it (gathered over the heads where they were split). A decode step
writes the new token's K/V (gathered over the heads where they are split)
on the rank whose part of the sequence holds its position, and the cross
attention reads this rank's KV heads out of the whole cross cache
(``MeshRun.own_kv_heads``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models.common import (AxisEnv, ParamBuilder, ShardingPolicy,
                                       cdtype, local, pspec, to_dtype)
from repro_torch.models.transformer import (OneDevice, _attn_mlp_layer,
                                            _plus_bias, attn_block, mlp_block,
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


def encode(cfg: ModelConfig, params, frames, *, run=None):
    """frames: (B, enc_seq, D) precomputed embeddings -> (B, enc_seq, D), or
    on a mesh this rank's frames of them (``run.encoder``'s split of the
    sequence). Each layer is ``transformer``'s block, bidirectional."""
    run = run if run is not None else OneDevice(cfg)
    frames = local(frames)
    ecfg = cfg.with_(num_layers=cfg.encoder_layers)
    erun = run.encoder(ecfg, frames.shape[1])
    x = erun.split(frames.to(cdtype(cfg)))
    o, S = erun.seq_offset, x.shape[1]
    pe = erun.param(params["enc_pos_embed"])[o:o + S]
    x = x + pe.to(x.device, x.dtype)[None]
    positions = o + torch.arange(S, device=x.device)[None, :]
    ep = params["encoder"]
    stacked = {k: w for k, w in ep.items() if not k.startswith("enc_final")}
    for i in range(cfg.encoder_layers):
        def body(x, i=i):
            lp = erun.layer_params(stacked, i)
            return _attn_mlp_layer(erun, lp, x, positions, causal=False)[0]
        x = erun.constrain(remat_wrap(cfg, body)(x))
    final = {k: erun.param(w) for k, w in ep.items() if k.startswith("enc_final")}
    return nn.apply_norm(ecfg, final, "enc_final", x)


def _dec_layer(cfg: ModelConfig, lp, x, positions, enc_k, enc_v, cache=None,
               cache_pos=None):
    """``dec_layer`` on one device."""
    return dec_layer(OneDevice(cfg), lp, x, positions, enc_k, enc_v, cache,
                     cache_pos)


def dec_layer(run, lp, x, positions, enc_k, enc_v, cache=None,
              cache_pos=None):
    """Self-attention (prefill, or decode against ``cache`` = (k, v) written
    in place at ``cache_pos``), cross-attention over the encoder's whole
    K/V, MLP; three pre-norms, in ``run.cfg`` with ``run``'s hooks.
    Returns (x, (k, v)). ``enc_k`` / ``enc_v``: the KV heads this rank's
    query heads read (``run.kv_group`` maps them where they are all)."""
    cfg = run.cfg
    x, kv = attn_block(run, lp, x, positions, cache, cache_pos)
    h = run.enter(nn.apply_norm(cfg, lp, "norm2", x))
    a = run.exit(attn.cross_attention(cfg, lp, h, enc_k, enc_v, bias=False,
                                      kv_group=run.kv_group,
                                      head_offset=run.head_offset))
    x = x + _plus_bias(cfg, lp, "cross_bo", a)
    return mlp_block(run, lp, x, "norm3"), kv


def forward_encdec(cfg: ModelConfig, params, batch, *,
                   return_cache: bool = False, last_token_only: bool = False,
                   run=None, with_loss: bool = False):
    """Teacher-forced training / prefill over ``frames`` + ``tokens``.
    Returns (logits, aux (zero), cache_or_None); with ``with_loss`` (labels
    in the batch) the mean token cross-entropy stands in the logits' place.
    ``run``: a ``MeshRun`` for one rank's shard of a mesh, as
    ``transformer.forward_decoder_only``'s: under sequence-parallel
    attention the encoder's frames and the decoder's tokens are split by
    sequence over the model axis, each layer's cross K/V are projected from
    the local frames and gathered whole; with the heads split, the frames
    are whole and each layer's cross K/V are projected in the
    tensor-parallel region, in ``run.cfg`` (this rank's KV heads)."""
    run = run if run is not None else OneDevice(cfg)
    enc_out = encode(cfg, params, batch["frames"], run=run)
    enc_len = local(batch["frames"]).shape[1]
    # every decoder layer's cross projections read the encoder's output
    # inside the tensor-parallel region (the identity off a head split)
    enc_in = run.enter(enc_out)
    x, positions = run.embed(params, {"tokens": batch["tokens"]})
    x = run.constrain(x)
    dp = params["decoder"]
    caches = {name: [] for name in ("k", "v", "cross_k", "cross_v")}
    for i in range(cfg.num_layers):
        def body(x, i=i):
            lp = run.layer_params(dp, i)
            ek, ev = attn.kv_proj(run.cfg, lp, enc_in, None, prefix="cross_",
                                  use_rope=False)
            ek, ev = run.cross_kv(ek, ev, enc_len)
            x, (k, v) = dec_layer(run, lp, x, positions, ek, ev)
            return x, (k, v, ek, ev)
        x, (k, v, ek, ev) = remat_wrap(cfg, body)(x)
        x = run.constrain(x)
        if return_cache:
            k, v = run.cache_kv(k, v)
            ek, ev = run.cross_cache(ek, ev)
            for name, t in zip(caches, (k, v, ek, ev)):
                caches[name].append(t)
    cache = None
    if return_cache:
        cache = run.stack_cache(caches)
    if last_token_only:
        x = run.last_token(x)
    logits = run.unembed(params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if with_loss:
        return run.xent(logits, batch["labels"]), aux, None
    return run.logits(logits), aux, cache


def decode_encdec(cfg: ModelConfig, params, cache, batch, *, run=None):
    """One-token decode against the cached self K/V (updated **in place**)
    and cross K/V (read only). Returns (logits (B, V), cache). ``run``: as
    ``forward_encdec``'s (a mesh's cache holds ``DTensor``s, the self K/V
    split by sequence over the model axis, the cross K/V whole, of which
    each rank reads its query heads' KV heads). ``pos``: a scalar, or one
    cache length a row (this rank's rows of it on a mesh)."""
    run = run if run is not None else OneDevice(cfg)
    x, positions = run.embed(params, batch)
    dp = params["decoder"]
    ck, cv = local(cache["k"]), local(cache["v"])
    xk, xv = local(cache["cross_k"]), local(cache["cross_v"])
    for i in range(cfg.num_layers):
        x, _ = dec_layer(run, run.layer_params(dp, i), x, positions,
                         run.own_kv_heads(xk[i]), run.own_kv_heads(xv[i]),
                         cache=(ck[i], cv[i]), cache_pos=batch["pos"])
    logits = run.unembed(params, x[:, 0:1, :])[:, 0, :]
    return run.logits(logits), cache


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
    K/V with the sequence on the model axis whatever the heads do, the cross
    K/V whole over it (1500 frames are not divisible by it)."""
    baxes = env.batch_axes(batch)
    kv = pspec(None, baxes, env.tp, None, None)
    cross = pspec(None, baxes, None, None, None)
    return {"k": kv, "v": kv, "cross_k": cross, "cross_v": cross}
