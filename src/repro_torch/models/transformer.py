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

One layer body and one forward / decode loop serve one device and one
rank's shard of a mesh: they call the hooks of a ``OneDevice`` (the
identity: weights as stored, activations and cache as they are) or of a
``MeshRun``. On a mesh the dense and VLM families (and the enc-dec, through
the same hooks) run as one rank's shard: the reference's sharding specs
(``act_sharding``, ``unembed_spec``, ``cache_specs_decoder_only``) lay out
the activations and the cache, ``constrain`` redistributes the residual
stream to them at the reference's sites, each layer gathers its weights
(ZeRO-3) inside its remat region, and the attention heads, the MLP width and
the vocabulary are split over the model axis (Megatron's tensor
parallelism). Where the model axis does not divide the heads the
activations are split by sequence instead (sequence-parallel attention:
each rank gathers the layer's K/V and attends its own query block at its
offset), and where the config asks for it (qwen2-vl) the residual stream
between tensor-parallel regions is split by sequence (Megatron's sequence
parallelism). The MoE family splits its experts over the model axis where
that axis divides them (expert parallelism): the routing runs on whole
routing groups on every model rank, each rank runs its own experts' FFNs on
their slots, and the exit of the expert region sums the ranks' parts (see
``MeshRun``'s expert hooks). The SSM and hybrid families split their SSM
heads over the model axis where it divides them: each rank scans its own
heads inside a tensor-parallel region (``MeshRun``'s SSM hooks), and the
hybrid's shared block runs the dense layer body through the same hooks.
"""
from __future__ import annotations

import copy
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (DENSE, ENCDEC, HYBRID, MOE, SSM, VLM,
                                      ModelConfig)
from repro_torch.models import attention as attn
from repro_torch.models import layers as nn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (AxisEnv, ParamBuilder, ShardingPolicy,
                                       dtensor_of, with_axis, cdtype,
                                       gather_param, gather_whole,
                                       global_shape, is_dtensor, layer_of,
                                       local, model_sum, placements, pspec,
                                       reshard, shard_local, spec_axes,
                                       to_dtype, tp_enter, tp_exit)

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
                      placement: Optional[Dict[str, str]] = None,
                      pol: Optional[ShardingPolicy] = None,
                      env: Optional[AxisEnv] = None
                      ) -> Tuple[PyTree, PyTree]:
    _require_decoder_only(cfg)
    b = ParamBuilder(cfg, generator, device, abstract=abstract,
                     placement=placement, pol=pol, env=env)
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
def _plus_bias(cfg: ModelConfig, lp, name: str, y):
    return y + lp[name].to(y.device, y.dtype) if cfg.use_bias else y


def attn_block(run, lp, x, positions, cache=None, cache_pos=None, *,
               causal: bool = True, norm: str = "norm1"):
    """The pre-norm self-attention block in ``run.cfg`` (a mesh's: the local
    heads and KV heads): ``x + attention(norm(x))``, and the new K/V (the
    cache itself in a decode step). ``run.enter`` / ``run.exit`` bound the
    tensor-parallel region (the identity on one device); the output bias is
    added after ``exit``, once, not on every model rank's partial sum.
    ``run.attend`` is where a sequence-parallel rank gathers the keys and
    values of the whole sequence."""
    cfg = run.cfg
    h = run.enter(nn.apply_norm(cfg, lp, norm, x))
    q = attn.q_proj(cfg, lp, h, positions)
    k, v = attn.kv_proj(cfg, lp, h, positions)
    if cache is None:
        a = run.attend(q, k, v, causal=causal)
        new_kv = (k, v)
    else:
        a = run.decode_attend(q, k, v, *cache, cache_pos)
        new_kv = cache
    a = run.exit(attn.out_proj(cfg, lp, a, bias=False))
    return x + _plus_bias(cfg, lp, "bo", a), new_kv


def mlp_block(run, lp, x, norm: str = "norm2"):
    """The pre-norm MLP block: ``x + mlp(norm(x))``, its output bias added
    once after the tensor-parallel exit."""
    cfg = run.cfg
    h = run.enter(nn.apply_norm(cfg, lp, norm, x))
    f = run.exit(nn.apply_mlp(cfg, lp, h, out_bias=False))
    return x + _plus_bias(cfg, lp, "b_out", f)


def _attn_mlp_layer(run, lp, x, positions, cache=None, cache_pos=None, *,
                    causal: bool = True):
    """Standard pre-norm block in ``run.cfg``: ``attn_block`` then the MLP
    (``mlp_block``) or the MoE FFN. Returns (x, new_kv, aux): aux is the MoE
    load-balancing loss of a forward (None for a dense layer or a decode
    step, whose aux nothing reads). ``causal=False`` is the encoder's
    bidirectional layer."""
    cfg = run.cfg
    x, new_kv = attn_block(run, lp, x, positions, cache, cache_pos,
                           causal=causal)
    if cfg.family != MOE:
        return mlp_block(run, lp, x), new_kv, None
    # the routing reads whole routing groups outside the expert region;
    # the dispatch input and the routing weights enter it, and its exit
    # sums the ranks' experts (all the identity on one device)
    h = run.moe_tokens(nn.apply_norm(cfg, lp, "norm2", x))
    out, probs, top_e = moe_mod.apply_moe(cfg, lp, h, experts=run.experts,
                                          enter=run.moe_enter)
    aux = run.balance_loss(probs, top_e) if cache is None else None
    return x + run.moe_exit(out), new_kv, aux


def _layer_params(lp_all, i: int):
    return {name: w[i] for name, w in lp_all.items()}


def _ssm_layer(run, lp, x, cache=None):
    """The pre-norm Mamba2 block: ``x + ssm(norm(x))``. On a mesh whose
    model axis splits the SSM heads, the normed input enters the
    tensor-parallel region (``run.ssm_enter``), the block runs on the rank's
    heads (``run.ssm_heads``) and the exit sums the ranks' out projections."""
    cfg = run.cfg
    h = run.ssm_enter(nn.apply_norm(cfg, lp, "norm1", x))
    y, new_cache = ssm_mod.apply_ssm(cfg, lp, h, cache, heads=run.ssm_heads,
                                     row_sum=run.model_sum,
                                     gather=run.ssm_gather)
    return x + run.ssm_exit(y), new_cache


def _ssm_stack(run, params, x, positions, *, caches=None,
               cache_pos=None, return_cache: bool = False):
    """The SSM / hybrid layer stack in ``run`` (one device, or one rank's
    shard of a mesh). Prefill (``caches`` None): returns (x, per-layer
    SSMCaches, per-group (k, v)) with the caches only when
    ``return_cache``. Decode: ``caches`` is the layer-stacked cache, each
    layer's slice is updated in place.

    Under autograd the remat nesting is the reference's: every SSM layer is
    wrapped by ``remat_wrap``, and for the hybrid each whole group too (its
    ``attn_every`` SSM layers and the shared attention + MLP block, whose
    residuals would otherwise be kept once per application); the tail layers
    are wrapped one by one. Each layer's weights, and the shared block's,
    are taken inside the region that uses them, so a mesh gathers them
    again in the recompute. Without autograd the wrappers do nothing."""
    cfg = run.cfg
    lp_all = params["layers"]
    B = x.shape[0]
    g = cfg.attn_every if cfg.family == HYBRID else cfg.num_layers
    n_groups = cfg.num_layers // g if cfg.family == HYBRID else 0
    if caches is not None:
        conv, state = local(caches["ssm"].conv), local(caches["ssm"].state)
    heads = run.ssm_heads[1] if run.ssm_heads is not None else None

    def ssm_layer(i):
        def body(x):
            if caches is not None:
                c = ssm_mod.SSMCache(conv[i], state[i])
            elif return_cache:
                c = ssm_mod.init_ssm_cache(cfg, B, x.dtype, x.device,
                                           heads=heads)
            else:
                c = None
            return _ssm_layer(run, run.layer_params(lp_all, i), x, c)
        return remat_wrap(cfg, body)

    def group(grp):
        kv = (None if caches is None
              else (local(caches["k"])[grp], local(caches["v"])[grp]))

        def body(x):
            cs = []
            for i in range(grp * g, (grp + 1) * g):
                x, c = ssm_layer(i)(x)
                cs.append(c)
            # the shared block is the dense layer body on unstacked weights
            x, new_kv, _ = _attn_mlp_layer(
                run, run.block_params(params["shared"]), x, positions, kv,
                cache_pos)
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
                         last_token_only: bool = False, run=None,
                         with_loss: bool = False):
    """Full-sequence forward. Returns (logits, aux_loss, cache_or_None);
    aux_loss is the MoE load-balancing loss summed over the layers (zero for
    the other families); the dense and MoE cache is ``{"k", "v"}`` of shape
    (L, B, S, KV, hd), the SSM and hybrid caches as ``_stacked_cache`` gives
    them. Differentiable for every family: serving calls it under
    ``torch.no_grad()`` (``Model.forward``), training with autograd on
    (``Model.loss_fn``). ``run``: a ``MeshRun`` for one rank's shard of a
    mesh (logits and cache then ``DTensor``s); one device by default. With
    ``with_loss`` (labels in the batch) the mean token cross-entropy, a 0-d
    tensor, stands in the logits' place."""
    _require_decoder_only(cfg)
    run = run if run is not None else OneDevice(cfg)
    x, positions = run.embed(params, batch)
    x = run.constrain(x)
    cache = None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family in _ATTN_STACK:
        lp_all = params["layers"]
        ks, vs, auxs = [], [], []
        for i in range(cfg.num_layers):
            # the weights are taken inside the remat region: on a mesh each
            # layer's gathered weights are dropped after it and gathered
            # again in the backward (ZeRO-3)
            def body(x, i=i):
                return _attn_mlp_layer(run, run.layer_params(lp_all, i), x,
                                       positions)
            x, (k, v), layer_aux = remat_wrap(cfg, body)(x)
            x = run.constrain(x)
            if layer_aux is not None:
                auxs.append(layer_aux)
            if return_cache:
                k, v = run.cache_kv(k, v)
                ks.append(k)
                vs.append(v)
        if auxs:
            aux = torch.stack(auxs).sum()
        if return_cache:
            cache = run.stack_cache({"k": ks, "v": vs})
    else:
        x, ssm_caches, kvs = _ssm_stack(run, params, x, positions,
                                        return_cache=return_cache)
        if return_cache:
            cache = run.ssm_cache(ssm_caches, kvs)
    if last_token_only:
        x = run.last_token(x)  # prefill: only the next-token logits are needed
    logits = run.unembed(params, x)
    if with_loss:
        return run.xent(logits, batch["labels"]), aux, None
    return run.logits(logits), aux, cache


# ---------------------------------------------------------------------------
# decode (single token, loop over the layer-stacked cache)
# ---------------------------------------------------------------------------
def decode_decoder_only(cfg: ModelConfig, params, cache, batch, *,
                        run=None):
    """One-token decode. cache arrays are layer-stacked (L leading) and are
    updated **in place**; the same tree is returned as the new cache.
    Returns (logits (B, V), cache). ``run``: as ``forward_decoder_only``'s
    (a mesh's cache holds ``DTensor``s, each rank updating its shard)."""
    _require_decoder_only(cfg)
    run = run if run is not None else OneDevice(cfg)
    x, positions = run.embed(params, batch)
    pos = batch["pos"]
    if cfg.family in _ATTN_STACK:
        lp_all = params["layers"]
        ck, cv = local(cache["k"]), local(cache["v"])
        for i in range(cfg.num_layers):
            x, _, _ = _attn_mlp_layer(run, run.layer_params(lp_all, i), x,
                                      positions, cache=(ck[i], cv[i]),
                                      cache_pos=pos)
    else:
        x, _, _ = _ssm_stack(run, params, x, positions, caches=cache,
                             cache_pos=pos)
    logits = run.unembed(params, x[:, 0:1, :])[:, 0, :]
    return run.logits(logits), cache


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


# ---------------------------------------------------------------------------
# sharding specs (the reference's, as tuples)
# ---------------------------------------------------------------------------
def act_sharding(env: AxisEnv, pol: ShardingPolicy, batch: int):
    if pol.profile == "fsdp_only":
        return pspec(env.batch_axes_joint(batch), None)
    baxes = env.batch_axes(batch)
    seq_ax = env.tp if pol.seq_sharded_acts else None
    return pspec(baxes, seq_ax)


def unembed_spec(env: AxisEnv, pol: ShardingPolicy, batch: int):
    """Sequence-sharded spec for the unembed input when the vocab dim cannot
    be model-sharded (see ``layers.unembed``)."""
    if env.size(env.tp) <= 1:
        return None
    if pol.profile == "fsdp_only":
        baxes = env.batch_axes_joint(batch)
        if baxes and env.tp not in baxes:
            # model axis idle for this batch: spread the logits' token dim
            return pspec(baxes, env.tp)
        return None
    if pol.profile == "tp" and not pol.vocab_sharded and not pol.seq_sharded_acts:
        return pspec(env.batch_axes(batch), env.tp)
    return None


def constrain(x, env: AxisEnv, pol: ShardingPolicy, batch: int):
    """The residual stream ``x`` (a ``DTensor`` on a mesh) redistributed to
    ``act_sharding``'s layout, padded to its rank: the reference's
    ``with_sharding_constraint``. A plain tensor, or a mesh whose every axis
    has size 1, is returned as it is."""
    if all(s == 1 for s in env.axis_sizes.values()) or not is_dtensor(x):
        return x
    spec = act_sharding(env, pol, batch)
    full = tuple(spec) + (None,) * (x.dim() - len(spec))
    return x.redistribute(env.mesh, placements(full, env))


def cache_specs_decoder_only(cfg: ModelConfig, batch: int, env: AxisEnv,
                             pol: ShardingPolicy) -> PyTree:
    """Specs matching ``init_cache_decoder_only``: the KV caches shard the
    batch over the batch axes; the second sharding axis is the KV heads when
    the model axis divides them (the per-token append stays shard-local),
    else the sequence."""
    baxes = env.batch_axes(batch)
    if pol.kv_sharded:
        kv_spec = pspec(None, baxes, None, env.tp, None)
    else:
        kv_spec = pspec(None, baxes, env.tp, None, None)
    if cfg.family in _ATTN_STACK:
        return {"k": kv_spec, "v": kv_spec}
    ssm_axis = env.tp if pol.ssm_sharded else None
    ssm_spec = ssm_mod.SSMCache(
        conv=pspec(None, baxes, None, None),
        state=pspec(None, baxes, ssm_axis, None, None))
    if cfg.family == SSM:
        return {"ssm": ssm_spec}
    return {"ssm": ssm_spec, "k": kv_spec, "v": kv_spec}


# ---------------------------------------------------------------------------
# where a call runs: one device, or one rank's shard of a mesh
# ---------------------------------------------------------------------------
# ROADMAP items of the parts a mesh does not run yet
DEFERRED = {
    "ssm_seq": "A32 (an SSM scan across a sequence split)",
    "encdec_tp": "A31 (enc-dec with its heads split over the model axis)",
    "encdec_serving": "A33 (an enc-dec tenant served on a mesh)",
    "vlm_serving": "A34 (a VLM tenant served through TenantEngine, whose "
                   "prefill and ticks feed text tokens)",
}


def deferred(cfg: ModelConfig, what: str):
    return NotImplementedError(
        f"{cfg.name} on a mesh needs a part that is not ported: ROADMAP "
        f"{DEFERRED[what]}")


def require_on_mesh(cfg: ModelConfig, pol: ShardingPolicy) -> None:
    """Raises, naming the ROADMAP item, unless a mesh runs ``cfg`` under
    ``pol``: the dense, MoE and VLM families with their heads split over
    the model axis (Megatron's tensor parallelism, with the residual stream
    split by sequence where ``pol.seq_residuals``), with their activations
    split by sequence instead (``pol.seq_parallel_attn``: the model axis
    does not divide the heads), or with the model axis a batch axis
    (fsdp_only), the MoE's experts split over the model axis where
    ``pol.experts_sharded``; the SSM and hybrid families with their SSM
    heads split over the model axis where ``pol.ssm_sharded`` (else whole on
    every model rank), except with their activations split by sequence; the
    encoder-decoder the same as the dense family, except with its heads
    split."""
    if cfg.family in (SSM, HYBRID) and pol.seq_sharded_acts:
        raise deferred(cfg, "ssm_seq")
    if cfg.family == ENCDEC and pol.head_sharded:
        raise deferred(cfg, "encdec_tp")


# the weights a layer uses inside its tensor-parallel region (between the
# all-reduce-backward entry and the all-reduce exit): a replicated one there
# (the KV projections when the model axis does not divide the KV heads,
# q_norm / k_norm) has a gradient part on each model rank
_TP_REGION = frozenset({"wq", "wk", "wv", "bq", "bk", "bv", "q_norm",
                        "k_norm", "wo", "w_in", "w_gate", "w_out", "b_in",
                        "b_gate"})
# an MoE layer's router and expert stacks: used on whole routing groups,
# the same on every model rank but for the experts each rank holds
_MOE_PARAMS = frozenset({"router", "w_in", "w_gate", "w_out"})
# an SSM layer's weights inside its tensor-parallel region when the model
# axis splits the SSM heads; in_zx is gathered whole there (``block_params``),
# each rank taking its heads' z and x columns, which lie in other ranks'
# shards
_SSM_REGION = frozenset({"in_zx", "in_bcdt", "conv_x", "conv_bc", "A_log",
                         "dt_bias", "D_skip", "ssm_norm", "out_proj"})


class OneDevice:
    """The hooks that the layer blocks and the forward / decode loops call,
    for one device: the weights as stored, the activations and the cache as
    they are, the head over the whole vocabulary. ``MeshRun`` gives the same
    hooks for one rank's shard of a mesh."""
    kv_group: Optional[int] = None      # expand_kv's, for local query heads
    head_offset: int = 0
    seq_offset: int = 0                 # position of the first local token
    experts = None                      # an MoE rank's (e0, E_local)
    ssm_heads = None                    # an SSM rank's (h0, nh_local)
    ssm_gather = None
    model_sum = None

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg      # the layer's config

    def encoder(self, ecfg: ModelConfig, seq_len: int):
        """The hooks of an encoder over ``seq_len`` frames."""
        return OneDevice(ecfg)

    def embed(self, params, batch):
        return _embed_input(self.cfg, params, batch)

    def split(self, x):
        """A whole-sequence input (B, S, ...) -> this rank's tokens."""
        return x

    def constrain(self, x):
        return x

    def layer_params(self, lp_all, i: int):
        return _layer_params(lp_all, i)

    def block_params(self, lp):
        """An unstacked block's weights (the hybrid's shared block)."""
        return lp

    def param(self, w, *, dtype=None):
        return w if dtype is None else w.to(dtype)

    def enter(self, x):
        return x

    def exit(self, x):
        return x

    def ssm_enter(self, x):
        return x

    def ssm_exit(self, x):
        return x

    def attend(self, q, k, v, *, causal: bool = True):
        return attn.attention_core(self.cfg, q, k, v, causal=causal,
                                   kv_group=self.kv_group,
                                   head_offset=self.head_offset)

    def moe_tokens(self, h):
        """The MoE block's input as whole routing groups."""
        return h

    def moe_enter(self, t):
        return t

    def moe_exit(self, out):
        return out

    def balance_loss(self, probs, top_e):
        return moe_mod.balance_loss(self.cfg, probs, top_e)

    def cross_kv(self, k, v, seq_len: int):
        """An encoder's K/V (``seq_len`` frames), whole for cross
        attention."""
        return k, v

    def decode_attend(self, q, k_new, v_new, cache_k, cache_v, cache_pos):
        return attn.cache_attend(self.cfg, q, k_new, v_new, cache_k, cache_v,
                                 cache_pos)

    def cache_kv(self, k, v):
        return k, v

    def stack_cache(self, parts, specs_of=None):
        """{name: per-layer tensors} -> {name: layer-stacked tensor}."""
        return {name: torch.stack(ps) for name, ps in parts.items()}

    def ssm_cache(self, ssm_caches, kvs):
        """The SSM / hybrid prefill's per-layer caches, layer-stacked."""
        return _stacked_cache(self.cfg, ssm_caches, kvs)

    def last_token(self, x):
        return x[:, -1:, :]

    def unembed(self, params, x):
        return nn.unembed(self.cfg, params, x)

    def logits(self, logits):
        return logits

    def xent(self, logits, labels):
        return nn.softmax_xent(logits, labels)


def _batch_dims(batch) -> Tuple[int, int]:
    """(B, S) of a batch: its tokens' (the decoder's, for an enc-dec), or a
    VLM's embeddings'."""
    x = batch["tokens"] if "tokens" in batch else batch["embeds"]
    return x.shape[0], x.shape[1]


class MeshRun(OneDevice):
    """The hooks for one sharded call: the activations' placements
    (``act_sharding``; a decode step takes its cache's batch axes), the
    mesh axes that split its tokens, the tensor-parallel region, and the
    local config (local heads, KV heads and MLP width), so the layer code
    runs unchanged on one rank's shard. ``params``, ``batch`` and the cache
    hold ``DTensor``s laid out by the model's specs; the activations between
    the hooks are local tensors.

    Where the policy splits the activations by sequence over the model axis
    (``seq_sharded_acts``), this rank holds tokens ``[seq_offset,
    seq_offset + S_local)`` of each of its sequences, at those positions.
    Sequence-parallel attention (``seq_parallel_attn``: the heads stay
    whole) gathers each layer's K/V over the model axis and attends the
    local queries at ``q_offset = seq_offset``; nothing else communicates
    over that axis but the loss. Megatron's sequence parallelism
    (``seq_residuals``: the heads split) keeps the residual stream split:
    ``enter`` all-gathers the sequence and ``exit`` reduce-scatters back to
    the split, and between them attention runs over the whole sequence on
    the local heads.

    An MoE layer routes whole routing groups on every model rank (gathered
    over the model axis where the activations are split by sequence), so
    the capacity and the drops are the unsharded step's. Where the model
    axis divides the experts (``experts_sharded``) each rank holds experts
    ``[e0, e0 + E_local)``: the dispatch input and the routing weights
    enter the expert region (Megatron's f), the rank runs its experts on
    their slots, and the exit sums the ranks' parts (an all-reduce, or a
    reduce-scatter back to the sequence split). Otherwise every rank runs
    every expert, and the exit only takes its own tokens. The router and
    the stacks are never a part over the model axis: their gradient is the
    same on every model rank, or the rank's own experts'."""

    def __init__(self, cfg: ModelConfig, env: AxisEnv, pol: ShardingPolicy,
                 batch, *, decode: bool = False):
        require_on_mesh(cfg, pol)
        B, S = _batch_dims(batch)
        self.cfg_global, self.env, self.pol, self.batch = cfg, env, pol, B
        self.mesh, self.seq_len = env.mesh, S
        self.act_spec = (pspec(env.batch_axes(B), None) if decode
                         else act_sharding(env, pol, B))
        self.act_pl = placements(tuple(self.act_spec) + (None,), env)
        self.token_axes = tuple(a for e in self.act_spec for a in spec_axes(e))
        # the heads (and the MLP width) split over the model axis
        self.tp = pol.head_sharded
        # the residual stream split by sequence over the model axis
        self.seq_acts = not decode and pol.seq_sharded_acts
        self.model_rank = self.mesh.get_local_rank(env.tp)
        n = env.size(env.tp) if self.tp else 1
        kv_local = cfg.num_kv_heads // n if pol.kv_sharded else cfg.num_kv_heads
        super().__init__(cfg.with_(
            num_heads=cfg.num_heads // n, num_kv_heads=kv_local,
            d_ff=cfg.d_ff // n if pol.ffn_sharded else cfg.d_ff))
        if self.tp and not pol.kv_sharded:
            self.kv_group = cfg.num_heads // cfg.num_kv_heads
            self.head_offset = self.model_rank * self.cfg.num_heads
        # the cache splits the sequence over the model axis when that axis
        # does not split the KV heads
        self.seq_split = not pol.kv_sharded and env.size(env.tp) > 1
        self.seq_offset = self._first_position()
        # the tokens' layout at the head: the activations', until the last
        # token is taken or the unembedding re-lays them
        self.head_spec = self.act_spec
        self._slot = None
        # MoE: the routing groups whole over the model axis, and the experts
        # of this rank where that axis splits them
        self.group_pl = placements(pspec(self.act_spec[0], None, None), env)
        if pol.experts_sharded:
            n_local = cfg.num_experts // env.size(env.tp)
            self.experts = (self.model_rank * n_local, n_local)
        # SSM: the heads of this rank where the model axis splits them
        if pol.ssm_sharded:
            n_local = cfg.ssm_heads // env.size(env.tp)
            self.ssm_heads = (self.model_rank * n_local, n_local)

    def _first_position(self) -> int:
        if not self.seq_acts:
            return 0
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        _, offset = compute_local_shape_and_global_offset(
            (self.batch, self.seq_len), self.mesh,
            placements(self.act_spec, self.env))
        return int(offset[1])

    def encoder(self, ecfg: ModelConfig, seq_len: int):
        """The same layout over an encoder's ``seq_len`` frames (its own
        split of the sequence) with its config."""
        run = copy.copy(self)
        run.cfg, run.seq_len = ecfg, seq_len
        run.seq_offset = run._first_position()
        return run

    # -- parameters --------------------------------------------------------
    def layer_params(self, lp_all, i: int):
        """Layer ``i``'s weights gathered (ZeRO-3), matrices cast to the
        compute dtype before the gather."""
        return self.block_params({name: layer_of(w, i)
                                  for name, w in lp_all.items()})

    def block_params(self, lp):
        """A block's weights gathered (ZeRO-3), matrices cast to the compute
        dtype before the gather. A weight used inside a tensor-parallel
        region has a gradient part on each model rank: the attention and MLP
        weights where the heads split, the SSM's where its heads split."""
        out = {}
        moe = self.cfg.family == MOE
        ssm_tp = self.ssm_heads is not None
        for name, w in lp.items():
            if moe and name in _MOE_PARAMS:
                partial = spec_axes(self.act_spec[0])
            else:
                inside = ((self.tp and name in _TP_REGION)
                          or (ssm_tp and name in _SSM_REGION))
                partial = self.token_axes + ((self.env.tp,) if inside else ())
            out[name] = gather_param(
                w, self.env, self.pol, partial_axes=partial,
                dtype=cdtype(self.cfg) if w.dim() >= 2 else None,
                whole=ssm_tp and name == "in_zx")
        return out

    def param(self, w, *, partial_axes=None, dtype=None):
        """A weight gathered for use on the local tokens (its gradient a
        part on every rank that splits them; ``partial_axes`` names other
        axes)."""
        return gather_param(w, self.env, self.pol,
                            partial_axes=(self.token_axes if partial_axes is None
                                          else partial_axes),
                            dtype=dtype)

    # -- layouts -----------------------------------------------------------
    def enter(self, x):
        return tp_enter(x, self.env, self.act_pl, self.seq_len) if self.tp else x

    def exit(self, x):
        return tp_exit(x, self.env, self.act_pl) if self.tp else x

    # -- the SSM's heads over the model axis ---------------------------------
    def ssm_enter(self, x):
        """Entry of an SSM layer's tensor-parallel region (Megatron's f)
        where the model axis splits its heads."""
        return tp_enter(x, self.env, self.act_pl) if self.ssm_heads else x

    def ssm_exit(self, x):
        """The ranks' out projections (row-parallel) summed."""
        return tp_exit(x, self.env, self.act_pl) if self.ssm_heads else x

    def model_sum(self, x):
        """The gated norm's square sums over the ranks' heads: an
        all-reduce forward and backward (``common.model_sum``)."""
        return model_sum(x, self.env, self.act_pl)

    def ssm_gather(self, x):
        """The conv window's x channels (this rank's heads' on the last
        dim) gathered whole over the model axis: the cache keeps every
        channel on every model rank."""
        from torch.distributed.tensor import Shard
        split = with_axis(self.act_pl, self.env, self.env.tp, Shard(2))
        return reshard(x, self.env, split, self.act_pl)

    # -- the expert region (MoE) ---------------------------------------------
    def moe_tokens(self, h):
        """Whole routing groups: where the sequence is split over the model
        axis, gathered over it. Every model rank then routes the same
        tokens, so the gradient that comes back is the same on each and
        the backward takes this rank's slice of it (``gather_whole``)."""
        if not self.seq_acts:
            return h
        return gather_whole(h, self.env, self.act_pl, self.seq_len)

    def moe_enter(self, t):
        """Entry of the expert region (Megatron's f on the whole groups):
        the identity forward; each rank's gradient, a part from its own
        experts, all-reduced over the model axis."""
        return tp_enter(t, self.env, self.group_pl)

    def moe_exit(self, out):
        """The MoE output laid out as the activations: the ranks' experts
        summed over the model axis (reduce-scattered to the sequence split
        where there is one); with every expert on every rank, this rank's
        tokens of the whole groups (the backward gathers the sequence)."""
        if self.experts is not None:
            return tp_exit(out, self.env, self.act_pl)
        if self.seq_acts:
            return reshard(out, self.env, self.group_pl, self.act_pl)
        return out

    def balance_loss(self, probs, top_e):
        """The load-balancing loss of the global batch, the same on every
        rank: the token means summed over the axes that split the routing
        groups (the batch axes) before the product."""
        from torch.distributed.tensor import DTensor, Partial, Replicate
        env = self.env
        axes = {a for a in spec_axes(self.act_spec[0]) if env.size(a) > 1}
        if not axes:
            return super().balance_loss(probs, top_e)
        n = math.prod(env.size(a) for a in axes)
        pl = tuple(Partial() if a in axes else Replicate()
                   for a in env.mesh_axes)

        def mean(t):
            part = t.sum(0) / (t.shape[0] * n)
            return DTensor.from_local(part, self.mesh, pl,
                                      run_check=False).full_tensor()
        return moe_mod.balance_loss(self.cfg, probs, top_e, mean=mean)

    def split(self, x):
        whole = placements(pspec(self.act_spec[0], None), self.env)
        return reshard(x, self.env, whole, self.act_pl) if self.seq_acts else x

    def constrain(self, x):
        d = dtensor_of(x, self.env, self.act_pl, self.seq_len)
        return constrain(d, self.env, self.pol, self.batch).to_local()

    def _lay(self, x, spec):
        """An input laid out by ``spec``: its local tensor."""
        if not is_dtensor(x):
            return x
        return x.redistribute(self.mesh, placements(tuple(spec), self.env)
                              ).to_local()

    def _rows(self, pos):
        """A decode step's cache positions: a scalar as it is; a per-row
        (B,) vector (ragged continuous batching) as this rank's rows, those
        of the activations' batch axes."""
        if not torch.is_tensor(pos) or pos.dim() == 0:
            return local(pos)
        return self._lay(pos, pspec(self.act_spec[0]))

    # -- embedding ---------------------------------------------------------
    def embed(self, params, batch):
        """The local tokens' embeddings (the tokens laid out as the
        activations first) and their positions: ``seq_offset`` onwards
        where the sequence is split. A VLM's embeddings are laid out the
        same; its (3, B, S) M-RoPE positions are the local tokens' under
        sequence-parallel attention, and whole under Megatron SP, where only
        the tensor-parallel region (the whole sequence) reads them."""
        cfg = self.cfg_global
        if cfg.family == VLM:
            x = self._lay(batch["embeds"], tuple(self.act_spec) + (None,))
            positions = self._lay(batch["positions"],
                                  pspec(None, self.act_spec[0], None))
            if self.seq_parallel:
                positions = positions[:, :, self.seq_offset:
                                      self.seq_offset + x.shape[1]]
            return x.to(cdtype(cfg)), positions
        tokens = self._lay(batch["tokens"], self.act_spec)
        positions = _positions(tokens, self._rows(batch.get("pos", None)),
                               self.seq_offset)
        if self.tp and self.pol.vocab_sharded:
            # the vocab-parallel lookup: every rank looks up the tokens of
            # its model group (the whole sequence under Megatron SP) in its
            # vocabulary shard, and the exit sums the shards (reduce-
            # scattering the sequence back to its split)
            if self.seq_acts:
                tokens = self._lay(batch["tokens"], pspec(self.act_spec[0], None))
            table = self.param(params["tok_embed"])         # (V / n, D)
            V = table.shape[0]
            idx = tokens.long() - self.model_rank * V
            inside = (idx >= 0) & (idx < V)
            rows = (nn.gather_rows(table, idx.clamp(0, V - 1))
                    * inside[..., None])
            x = self.exit(rows.to(cdtype(cfg)))
            if cfg.learned_pos:
                pe = self.param(params["pos_embed"])
                x = x + nn.take_rows(pe, positions).to(x.dtype)
            return x, positions
        p = {"tok_embed": self.param(params["tok_embed"])}
        if cfg.learned_pos:
            p["pos_embed"] = self.param(params["pos_embed"])
        return nn.embed_tokens(cfg, p, tokens,
                               positions if cfg.learned_pos else None), positions

    # -- attention ---------------------------------------------------------
    @property
    def seq_parallel(self) -> bool:
        """Sequence-parallel attention: the sequence split, the heads whole."""
        return self.seq_acts and not self.tp

    def attend(self, q, k, v, *, causal: bool = True):
        """Sequence-parallel: the whole sequence's K/V gathered over the
        model axis (the backward reduce-scatters their gradients), and the
        local queries attend them at ``q_offset = seq_offset`` when causal:
        row ``i`` sees keys ``0..seq_offset + i``."""
        if not self.seq_parallel:
            return super().attend(q, k, v, causal=causal)
        k, v = (tp_enter(t, self.env, self.act_pl, self.seq_len) for t in (k, v))
        return attn.attention_core(self.cfg, q, k, v, causal=causal,
                                   q_offset=self.seq_offset if causal else 0)

    def cross_kv(self, k, v, seq_len: int):
        """An encoder's K/V, split by its frames under sequence-parallel
        attention, gathered whole over the model axis (``seq_len`` frames:
        the gather pads an uneven split and trims it)."""
        if not self.seq_parallel:
            return k, v
        return tuple(tp_enter(t, self.env, self.act_pl, seq_len) for t in (k, v))

    # -- the cache ---------------------------------------------------------
    def decode_attend(self, q, k_new, v_new, cache_k, cache_v, cache_pos):
        """With the cache's sequence split over the model axis: writes the
        new K/V on the rank whose part holds the row's position and attends
        over this rank's part, the ranks' softmax stats combined
        (``attention.decode_attention``'s ``model_group``). ``cache_pos`` is
        a scalar, or one position a row (ragged continuous batching: each
        row written on its own rank, each masked at its own length). Where
        the query heads are split over that axis too, the combine is over
        every head: the queries are gathered over the model axis first and
        each rank keeps its own heads' output. Otherwise every rank holds
        the whole sequence of its batch rows and KV heads, as on one
        device."""
        if self._slot is None:
            self._slot = self._cache_slot(cache_pos, cache_k.shape[1],
                                          q.device)
        pos, offset, inside, idx = self._slot
        if not self.seq_split:
            return super().decode_attend(q, k_new, v_new, cache_k, cache_v,
                                         pos)
        for c, new in ((cache_k, k_new), (cache_v, v_new)):
            if pos.dim() == 0:
                c.index_copy_(1, idx, torch.where(inside, new.to(c.dtype),
                                                  c.index_select(1, idx)))
            else:
                rows = torch.arange(c.shape[0], device=c.device)
                c[rows, idx] = torch.where(inside[:, None, None],
                                           new[:, 0].to(c.dtype), c[rows, idx])
        group = self.mesh.get_group(self.env.tp)
        if not self.tp:
            return attn.decode_attention(q, cache_k, cache_v, kv_len=pos + 1,
                                         k_offset=offset, model_group=group)
        env, H = self.env, q.shape[2]
        split = placements(pspec(self.act_spec[0], None, env.tp, None), env)
        whole = placements(pspec(self.act_spec[0], None, None, None), env)
        out = attn.decode_attention(reshard(q, env, split, whole), cache_k,
                                    cache_v, kv_len=pos + 1, k_offset=offset,
                                    model_group=group)
        return out[:, :, self.head_offset:self.head_offset + H]

    def _cache_slot(self, cache_pos, S_local: int, device):
        """(pos, offset, inside, idx) of a decode step, computed once for
        every layer: this rank's rows' positions; where the cache splits its
        sequence, the rank's first position, whether each position lies in
        its part, and the local index it is written at (clamped)."""
        pos = self._rows(cache_pos)
        if not self.seq_split:
            return pos, None, None, None
        pos = torch.as_tensor(pos, device=device).long()
        offset = self.model_rank * S_local
        li = pos - offset
        idx = li.clamp(0, S_local - 1)
        return (pos, offset, (li >= 0) & (li < S_local),
                idx.reshape(1) if pos.dim() == 0 else idx)

    def cache_kv(self, k, v):
        """A layer's K/V laid out as the cache (``cache_specs_decoder_only``
        less its layer dim). A sequence-parallel rank's own K/V are its part
        of the cache's sequence split already."""
        env = self.env
        spec = cache_specs_decoder_only(self.cfg_global, self.batch, env,
                                        self.pol)["k"][1:]
        src = placements(pspec(self.act_spec[0],
                               env.tp if self.seq_parallel else None,
                               env.tp if (self.tp and self.pol.kv_sharded)
                               else None, None), env)
        dst = placements(spec, env)
        return reshard(k, env, src, dst), reshard(v, env, src, dst)

    def stack_cache(self, parts, specs_of=None):
        """{name: per-layer local tensors} -> {name: layer-stacked
        ``DTensor``} laid out by the spec tree ``specs_of(cfg, batch, env,
        pol)`` gives (``cache_specs_decoder_only`` by default)."""
        cfg, env = self.cfg_global, self.env
        specs = (specs_of or cache_specs_decoder_only)(cfg, self.batch, env,
                                                        self.pol)
        out = {}
        for name, ps in parts.items():
            x, pl = torch.stack(ps), placements(specs[name], env)
            out[name] = shard_local(
                x, global_shape(x, env, pl, self.seq_len, seq_dim=2), pl,
                env.mesh)
        return out

    def ssm_cache(self, ssm_caches, kvs):
        """The SSM / hybrid prefill's per-layer caches -> the layer-stacked
        cache as ``DTensor``s laid out by ``cache_specs_decoder_only``: the
        conv windows (whole over the model axis) and the states (this rank's
        heads where the model axis splits them) moved from the activations'
        batch axes to the cache's (fsdp_only's batch spans the model axis,
        the cache's does not), the hybrid's K/V as ``cache_kv`` lays them."""
        env = self.env
        specs = cache_specs_decoder_only(self.cfg_global, self.batch, env,
                                         self.pol)
        rows = self.act_spec[0]
        heads = env.tp if self.ssm_heads else None
        out = {}
        for field, spec, src in (
                ("conv", specs["ssm"].conv, pspec(None, rows, None, None)),
                ("state", specs["ssm"].state,
                 pspec(None, rows, heads, None, None))):
            x = torch.stack([getattr(c, field) for c in ssm_caches])
            dst = placements(spec, env)
            x = reshard(x, env, placements(src, env), dst)
            out[field] = shard_local(x, global_shape(x, env, dst), dst,
                                     env.mesh)
        cache = {"ssm": ssm_mod.SSMCache(**out)}
        if kvs:
            kvs = [self.cache_kv(k, v) for k, v in kvs]
            cache.update(self.stack_cache({"k": [k for k, _ in kvs],
                                           "v": [v for _, v in kvs]}))
        return cache

    # -- head and loss -----------------------------------------------------
    def last_token(self, x):
        """The last token of each local sequence, whole over the model
        axis: where the sequence is split, the rank that holds position
        ``S - 1`` sends it to the others (a sum over the model axis of it
        and zeros)."""
        if not self.seq_acts:
            return super().last_token(x)
        from torch.distributed.tensor import DTensor, Partial
        env = self.env
        own = self.seq_offset <= self.seq_len - 1 < self.seq_offset + x.shape[1]
        t = (x[:, -1:, :] if own
             else x.new_zeros((x.shape[0], 1) + tuple(x.shape[2:])))
        self.head_spec = pspec(self.act_spec[0], None)
        whole = placements(tuple(self.head_spec) + (None,), env)
        part = DTensor.from_local(t, self.mesh,
                                  with_axis(whole, env, env.tp, Partial()),
                                  run_check=False)
        return part.redistribute(self.mesh, whole).to_local()

    def unembed(self, params, x):
        """Logits of the local tokens: the local vocabulary shard when the
        vocab is model-sharded (the normed input enters the
        tensor-parallel region, its sequence gathered under Megatron SP),
        else the whole vocabulary of this rank's tokens: those of its model
        rank's token slice when ``unembed_spec`` splits them, its own part
        of the sequence under sequence-parallel attention. ``head_spec``
        then holds the logits' token layout."""
        cfg, env = self.cfg_global, self.env
        in_spec = self.head_spec
        in_pl = placements(tuple(in_spec) + (None,), env)
        shard = None
        if self.tp and self.pol.vocab_sharded:
            shard = lambda h: tp_enter(h, env, in_pl, self.seq_len)
            self.head_spec = pspec(in_spec[0], None)
        else:
            useq = unembed_spec(env, self.pol, self.batch)
            if useq is not None and x.shape[-2] > 1:
                dst = placements(tuple(useq) + (None,), env)
                shard = lambda h: reshard(h, env, in_pl, dst)
                self.head_spec = useq
        axes = lambda spec: tuple(a for e in spec for a in spec_axes(e))
        head = "tok_embed" if cfg.tie_embeddings else "lm_head"
        p = {"final_norm_scale": self.param(params["final_norm_scale"],
                                            partial_axes=axes(in_spec)),
             head: self.param(params[head], partial_axes=axes(self.head_spec),
                              dtype=cdtype(cfg))}
        if cfg.norm == "layernorm":
            p["final_norm_bias"] = self.param(params["final_norm_bias"],
                                              partial_axes=axes(in_spec))
        return nn.unembed(cfg, p, x, seq_shard=shard)

    def logits(self, logits):
        """The local logits as a ``DTensor``: laid out by ``head_spec`` and,
        when the vocabulary is model-sharded, the model axis."""
        env = self.env
        vocab = env.tp if self.tp and self.pol.vocab_sharded else None
        tokens = tuple(self.head_spec[1:]) if logits.dim() == 3 else ()
        pl = placements(pspec(self.head_spec[0], *tokens, vocab), env)
        shape = global_shape(logits, env, pl,
                             self.seq_len if logits.dim() == 3 else None)
        return shard_local(logits, shape, pl, env.mesh)

    def xent(self, logits, labels) -> torch.Tensor:
        """The global mean token cross-entropy from this rank's logits: the
        labels laid out as the logits' tokens (``head_spec``), the
        vocab-sharded log-sum-exp and label logit summed over the model
        axis, the local token sum divided by the global token count, summed
        over the axes that split the tokens. A plain 0-d tensor, the same on
        every rank."""
        from torch.distributed import _functional_collectives as funcol
        from torch.distributed.tensor import DTensor, Partial, Replicate
        env, head_spec = self.env, tuple(self.head_spec)
        labels = local(labels)
        head_pl = placements(head_spec, env)
        if head_spec != tuple(self.act_spec):
            labels = reshard(labels, env, placements(self.act_spec, env),
                             head_pl)
        lf = logits.float()
        if self.tp and self.pol.vocab_sharded:
            V = lf.shape[-1]
            m = funcol.all_reduce(lf.detach().amax(dim=-1), "max",
                                  self.mesh.get_group(env.tp))
            s = torch.exp(lf - m[..., None]).sum(dim=-1)
            lse = torch.log(tp_exit(s, env, head_pl)) + m
            idx = labels.long() - self.model_rank * V
            inside = (idx >= 0) & (idx < V)
            ll = lf.gather(-1, idx.clamp(0, V - 1)[..., None])[..., 0]
            ll = tp_exit(ll * inside, env, head_pl)
        else:
            lse = torch.logsumexp(lf, dim=-1)
            ll = lf.gather(-1, labels.long()[..., None])[..., 0]
        n_tokens = self.batch * self.seq_len
        part = (lse - ll).sum() / n_tokens
        split = {a for e in head_spec for a in spec_axes(e)}
        pl = tuple(Partial() if a in split and env.size(a) > 1 else Replicate()
                   for a in env.mesh_axes)
        return DTensor.from_local(part, self.mesh, pl,
                                  run_check=False).full_tensor()


def _positions(tokens, start, offset: int = 0):
    """Positions of the local tokens: ``offset`` (the first local token's
    position in its sequence) onwards, after ``start`` (a decode step's
    cache length: a scalar, or this rank's rows' (B_local,) lengths)."""
    S = tokens.shape[1]
    ar = offset + torch.arange(S, device=tokens.device)
    if start is None:
        return ar[None, :]
    start = torch.as_tensor(start, device=tokens.device)
    if start.dim() == 1:    # per-row positions (ragged decode): local rows
        return start[:, None] + ar[None, :]
    return start + ar[None, :]
