"""Decoder-only LM assembly — dense, MoE, VLM, SSM and hybrid families.

The reference scans over stacked layer parameters; here a Python loop indexes
the same stacked tensors (``layers/wq`` with a leading ``L`` dim). Under
autograd each layer is wrapped by ``remat_wrap`` (``cfg.remat``), as the
reference wraps its scan body, and each hybrid group as a whole too. MoE:
the dense block with ``models/moe.py``'s expert FFN in place of the MLP,
and the load-balancing loss summed over the layers as
the forward's aux output. Hybrid (Zamba2): groups of ``attn_every`` Mamba2
layers, each group followed by one shared, unstacked attention + MLP block,
then a tail of the remaining SSM layers. VLM (Qwen2-VL): the dense block
over precomputed input embeddings with three M-RoPE position streams; its
``positions`` are the rotary angles' and ``pos`` the cache index, and after
an image the first is smaller than the second. The encoder-decoder family is
``models/encdec.py``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import DENSE, HYBRID, MOE, SSM, VLM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import ParamBuilder, cdtype, to_dtype

PyTree = Any

_ATTN_STACK = (DENSE, MOE, VLM)     # a stack of attention + FFN layers


def _require_decoder_only(cfg: ModelConfig) -> None:
    if cfg.family not in _ATTN_STACK + (SSM, HYBRID):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} is not "
                         f"decoder-only")


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
                      device: torch.device, *, abstract: bool = False,
                      placement: Optional[Dict[str, str]] = None
                      ) -> Tuple[PyTree, PyTree]:
    _require_decoder_only(cfg)
    b = ParamBuilder(cfg, generator, device, abstract=abstract,
                     placement=placement)
    nn.init_embeddings(b)
    lb = b.child("layers")
    if cfg.family in _ATTN_STACK:
        attn.init_attention(lb, stacked=True)
        nn.init_norm(lb, "norm1", stacked=True)
        nn.init_norm(lb, "norm2", stacked=True)
        if cfg.family == MOE:
            moe_mod.init_moe(lb, stacked=True)
        else:
            nn.init_mlp(lb, stacked=True)
    else:
        ssm_mod.init_ssm(lb, stacked=True)
        nn.init_norm(lb, "norm1", stacked=True)
    if cfg.family == HYBRID:
        sb = b.child("shared")  # one shared attention + MLP block (Zamba2)
        attn.init_attention(sb, stacked=False)
        nn.init_mlp(sb)
        nn.init_norm(sb, "norm1")
        nn.init_norm(sb, "norm2")
    return b.params, b.specs


# ---------------------------------------------------------------------------
# layer body (shared by prefill / decode)
# ---------------------------------------------------------------------------
def _attn_mlp_layer(cfg: ModelConfig, lp, x, positions, cache=None,
                    cache_pos=None):
    """Standard pre-norm block. Returns (x, new_kv, aux): aux is the MoE
    load-balancing loss of a forward (None for a dense layer or a decode
    step, whose aux nothing reads)."""
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
    if cfg.family != MOE:
        return x + nn.apply_mlp(cfg, lp, h), new_kv, None
    out, probs, top_e = moe_mod.apply_moe(cfg, lp, h)
    aux = moe_mod.balance_loss(cfg, probs, top_e) if cache is None else None
    return x + out, new_kv, aux


def _layer_params(lp_all, i: int):
    return {name: w[i] for name, w in lp_all.items()}


def _ssm_layer(cfg: ModelConfig, lp, x, cache=None):
    h = nn.apply_norm(cfg, lp, "norm1", x)
    y, new_cache = ssm_mod.apply_ssm(cfg, lp, h, cache)
    return x + y, new_cache


def _ssm_stack(cfg: ModelConfig, params, x, positions, *, caches=None,
               cache_pos=None, return_cache: bool = False):
    """The SSM / hybrid layer stack. Prefill (``caches`` None): returns
    (x, per-layer SSMCaches, per-group (k, v)) with the caches only when
    ``return_cache``. Decode: ``caches`` is the layer-stacked cache, each
    layer's slice is updated in place.

    Under autograd the remat nesting is the reference's: every SSM layer is
    wrapped by ``remat_wrap``, and for the hybrid each whole group too (its
    ``attn_every`` SSM layers and the shared attention + MLP block, whose
    residuals would otherwise be kept once per application); the tail layers
    are wrapped one by one. Without autograd the wrappers do nothing."""
    lp_all = params["layers"]
    B = x.shape[0]
    g = cfg.attn_every if cfg.family == HYBRID else cfg.num_layers
    n_groups = cfg.num_layers // g if cfg.family == HYBRID else 0

    def ssm_layer(i):
        lp = _layer_params(lp_all, i)

        def body(x):
            if caches is not None:
                c = ssm_mod.SSMCache(caches["ssm"].conv[i],
                                     caches["ssm"].state[i])
            elif return_cache:
                c = ssm_mod.init_ssm_cache(cfg, B, x.dtype, x.device)
            else:
                c = None
            return _ssm_layer(cfg, lp, x, c)
        return remat_wrap(cfg, body)

    def group(grp):
        kv = None if caches is None else (caches["k"][grp], caches["v"][grp])

        def body(x):
            cs = []
            for i in range(grp * g, (grp + 1) * g):
                x, c = ssm_layer(i)(x)
                cs.append(c)
            # the shared block is the dense layer body on unstacked weights
            x, new_kv, _ = _attn_mlp_layer(cfg, params["shared"], x,
                                           positions, kv, cache_pos)
            return x, cs, new_kv
        return remat_wrap(cfg, body)

    ssm_caches, kvs = [], []
    for grp in range(n_groups):
        x, cs, kv = group(grp)(x)
        ssm_caches += cs
        kvs.append(kv)
    for i in range(n_groups * g, cfg.num_layers):
        x, c = ssm_layer(i)(x)
        ssm_caches.append(c)
    return x, ssm_caches, kvs


def _stacked_cache(cfg: ModelConfig, ssm_caches, kvs):
    """Per-layer prefill caches -> the layer-stacked cache tree:
    ``{"ssm": SSMCache((L, B, W-1, C), (L, B, nh, hp, N))}`` plus, for the
    hybrid, ``"k"`` / ``"v"`` of shape (n_groups, B, S, KV, hd)."""
    cache = {"ssm": ssm_mod.SSMCache(
        conv=torch.stack([c.conv for c in ssm_caches]),
        state=torch.stack([c.state for c in ssm_caches]))}
    if cfg.family == HYBRID:
        cache["k"] = torch.stack([k for k, _ in kvs])
        cache["v"] = torch.stack([v for _, v in kvs])
    return cache


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------
def _embed_input(cfg: ModelConfig, params, batch):
    """Returns (x, positions): VLM takes ``embeds`` and its (3, B, S)
    M-RoPE ``positions`` as given; every other family embeds ``tokens`` at
    ``pos`` + 0..S-1 (``pos`` a scalar or per row, 0 when absent)."""
    if cfg.family == VLM:
        return batch["embeds"].to(cdtype(cfg)), batch["positions"]
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
    aux_loss is the MoE load-balancing loss summed over the layers (zero for
    the other families); the dense and MoE cache is ``{"k", "v"}`` of shape
    (L, B, S, KV, hd), the SSM and hybrid caches as ``_stacked_cache`` gives
    them. Differentiable for every family: serving calls it under
    ``torch.no_grad()`` (``Model.forward``), training with autograd on
    (``Model.loss_fn``)."""
    _require_decoder_only(cfg)
    x, positions = _embed_input(cfg, params, batch)
    cache = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in _ATTN_STACK:
        lp_all = params["layers"]
        ks, vs, auxs = [], [], []
        for i in range(cfg.num_layers):
            lp = _layer_params(lp_all, i)

            def body(x, lp=lp):
                return _attn_mlp_layer(cfg, lp, x, positions)
            x, (k, v), layer_aux = remat_wrap(cfg, body)(x)
            if layer_aux is not None:
                auxs.append(layer_aux)
            if return_cache:
                ks.append(k)
                vs.append(v)
        if auxs:
            aux = torch.stack(auxs).sum()
        if return_cache:
            cache = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        x, ssm_caches, kvs = _ssm_stack(cfg, params, x, positions,
                                        return_cache=return_cache)
        if return_cache:
            cache = _stacked_cache(cfg, ssm_caches, kvs)
    if last_token_only:
        x = x[:, -1:, :]  # prefill: only the next-token logits are needed
    logits = nn.unembed(cfg, params, x)
    return logits, aux, cache


# ---------------------------------------------------------------------------
# decode (single token, loop over the layer-stacked cache)
# ---------------------------------------------------------------------------
def decode_decoder_only(cfg: ModelConfig, params, cache, batch):
    """One-token decode. cache arrays are layer-stacked (L leading) and are
    updated **in place**; the same tree is returned as the new cache.
    Returns (logits (B, V), cache)."""
    _require_decoder_only(cfg)
    x, positions = _embed_input(cfg, params, batch)
    pos = batch["pos"]
    if cfg.family in _ATTN_STACK:
        lp_all = params["layers"]
        for i in range(cfg.num_layers):
            x, _, _ = _attn_mlp_layer(cfg, _layer_params(lp_all, i), x,
                                      positions,
                                      cache=(cache["k"][i], cache["v"][i]),
                                      cache_pos=pos)
    else:
        x, _, _ = _ssm_stack(cfg, params, x, positions, caches=cache,
                             cache_pos=pos)
    logits = nn.unembed(cfg, params, x[:, 0:1, :])[:, 0, :]
    return logits, cache


# ---------------------------------------------------------------------------
# cache construction
# ---------------------------------------------------------------------------
def init_cache_decoder_only(cfg: ModelConfig, batch: int, max_seq: int,
                            dtype=torch.bfloat16, device=None) -> PyTree:
    """The layer-stacked cache: dense ``{"k", "v"}`` (L, B, max_seq, KV,
    hd); SSM ``{"ssm": SSMCache}`` with the conv window in ``dtype`` and the
    state in fp32; hybrid both, KV stacked over the n_groups shared-block
    applications."""
    _require_decoder_only(cfg)
    dtype = to_dtype(dtype)
    cache = {}
    if cfg.family not in _ATTN_STACK:
        cache["ssm"] = ssm_mod.init_ssm_cache(cfg, batch, dtype, device,
                                              layers=cfg.num_layers)
    if cfg.family != SSM:
        # hybrid: one shared-block application per whole group of layers
        n = (cfg.num_layers if cfg.family in _ATTN_STACK
             else cfg.num_layers // cfg.attn_every)
        shape = (n, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        cache["k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache
