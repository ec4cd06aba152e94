"""Decoder-only LM assembly — dense family.

The reference scans over stacked layer parameters; here a Python loop indexes
the same stacked tensors (``layers/wq`` with a leading ``L`` dim). Under
autograd each layer is wrapped by ``remat_wrap`` (``cfg.remat``), as the
reference wraps its scan body. MoE, VLM, SSM and hybrid branches are not
ported yet and raise ``NotImplementedError`` naming the ROADMAP item that
brings them.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models.common import ParamBuilder, to_dtype

PyTree = Any

_PENDING = {
    MOE: "MoE family: ROADMAP queue A item 10 (with kernel grouped_matmul)",
    SSM: "SSM family: ROADMAP queue A item 9 (with kernel ssd_scan)",
    HYBRID: "hybrid family: ROADMAP queue A item 9 (with kernel ssd_scan)",
    VLM: "VLM family: ROADMAP queue A item 11 (M-RoPE, embeds input)",
}


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != DENSE:
        raise NotImplementedError(
            f"{cfg.name}: {_PENDING.get(cfg.family, cfg.family)} "
            f"is not ported yet")


# ---------------------------------------------------------------------------
# remat policy
# ---------------------------------------------------------------------------
def offload_activation(t):
    """Pack hook of ``remat="offload"``: a tensor autograd saves (the layer's
    input) goes to pinned host memory, as the reference's
    ``save_and_offload_only_these_names(["layer_act"],
    offload_dst="pinned_host")``. ``offload_activation.d2h_bytes`` counts the
    bytes sent to the host."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
    host.copy_(t, non_blocking=t.is_cuda)
    offload_activation.d2h_bytes += t.numel() * t.element_size()
    return t.device, host


offload_activation.d2h_bytes = 0


def _restore_activation(packed):
    device, host = packed
    return host.to(device, non_blocking=True)


def remat_wrap(cfg: ModelConfig, fn):
    """``fn(x)`` with the reference's remat policy, under autograd only:
    ``"none"`` saves everything; ``"layer"`` / ``"full"`` save only the
    layer's input and recompute the rest in the backward
    (``torch.utils.checkpoint``); ``"offload"`` does the same with that
    input kept in pinned host memory until the backward needs it. The
    parameters and positions are taken by ``fn``'s closure, so the input is
    the one tensor the checkpoint saves."""
    if cfg.remat == "none":
        return fn

    def wrapped(x):
        if not torch.is_grad_enabled():
            return fn(x)
        if cfg.remat == "offload":
            with torch.autograd.graph.saved_tensors_hooks(offload_activation,
                                                          _restore_activation):
                return checkpoint(fn, x, use_reentrant=False)
        return checkpoint(fn, x, use_reentrant=False)
    return wrapped


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------
def init_decoder_only(cfg: ModelConfig, generator: Optional[torch.Generator],
                      device: torch.device, *, abstract: bool = False
                      ) -> Tuple[PyTree, PyTree]:
    _require_dense(cfg)
    b = ParamBuilder(cfg, generator, device, abstract=abstract)
    nn.init_embeddings(b)
    lb = b.child("layers")
    attn.init_attention(lb, stacked=True)
    nn.init_norm(lb, "norm1", stacked=True)
    nn.init_norm(lb, "norm2", stacked=True)
    nn.init_mlp(lb, stacked=True)
    return b.params, b.specs


# ---------------------------------------------------------------------------
# layer body (shared by prefill / decode)
# ---------------------------------------------------------------------------
def _attn_mlp_layer(cfg: ModelConfig, lp, x, positions, cache=None,
                    cache_pos=None):
    """Standard pre-norm block. Returns (x, new_kv)."""
    h = nn.apply_norm(cfg, lp, "norm1", x)
    if cache is None:
        a, new_kv = attn.self_attention(cfg, lp, h, positions)
    else:
        ck, cv = cache
        a, ck, cv = attn.decode_self_attention(cfg, lp, h, ck, cv, cache_pos,
                                               positions)
        new_kv = (ck, cv)
    x = x + a
    h = nn.apply_norm(cfg, lp, "norm2", x)
    return x + nn.apply_mlp(cfg, lp, h), new_kv


def _layer_params(lp_all, i: int):
    return {name: w[i] for name, w in lp_all.items()}


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _embed_input(cfg: ModelConfig, params, batch):
    """Returns (x, positions)."""
    tokens = batch["tokens"]
    S = tokens.shape[1]
    ar = torch.arange(S, device=tokens.device)
    start = batch.get("pos", None)
    if start is None:
        positions = ar[None, :]
    else:
        start = torch.as_tensor(start, device=tokens.device)
        if start.dim() == 1:  # per-row positions (ragged decode)
            positions = start[:, None] + ar[None, :]
        else:
            positions = start + ar[None, :]
    x = nn.embed_tokens(cfg, params, tokens,
                        positions if cfg.learned_pos else None)
    return x, positions


def forward_decoder_only(cfg: ModelConfig, params, batch, *,
                         return_cache: bool = False,
                         last_token_only: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, cache_or_None);
    the cache is ``{"k", "v"}`` of shape (L, B, S, KV, hd). Differentiable:
    serving calls it under ``torch.no_grad()`` (``Model.forward``), training
    with autograd on (``Model.loss_fn``)."""
    _require_dense(cfg)
    x, positions = _embed_input(cfg, params, batch)
    lp_all = params["layers"]
    ks, vs = [], []
    for i in range(cfg.num_layers):
        lp = _layer_params(lp_all, i)

        def body(x, lp=lp):
            return _attn_mlp_layer(cfg, lp, x, positions)
        x, (k, v) = remat_wrap(cfg, body)(x)
        if return_cache:
            ks.append(k)
            vs.append(v)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs)} if return_cache else None
    if last_token_only:
        x = x[:, -1:, :]  # prefill: only the next-token logits are needed
    logits = nn.unembed(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# decode (single token, loop over the layer-stacked cache)
# ---------------------------------------------------------------------------
def decode_decoder_only(cfg: ModelConfig, params, cache, batch):
    """One-token decode. cache arrays are layer-stacked (L leading) and are
    updated **in place**; the same tree is returned as the new cache.
    Returns (logits (B, V), cache)."""
    _require_dense(cfg)
    x, positions = _embed_input(cfg, params, batch)
    pos = batch["pos"]
    lp_all = params["layers"]
    for i in range(cfg.num_layers):
        x, _ = _attn_mlp_layer(cfg, _layer_params(lp_all, i), x, positions,
                               cache=(cache["k"][i], cache["v"][i]),
                               cache_pos=pos)
    logits = nn.unembed(cfg, params, x[:, 0:1, :])[:, 0, :]
    return logits, cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------
def init_cache_decoder_only(cfg: ModelConfig, batch: int, max_seq: int,
                            dtype=torch.bfloat16, device=None) -> PyTree:
    _require_dense(cfg)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    dtype = to_dtype(dtype)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
