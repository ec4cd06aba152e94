"""Mixture-of-Experts with capacity-based dispatch (GShard-style semantics),
the counterpart of ``repro/models/moe.py``.

Routing is computed per *group* (one batch row, or one ``moe_group_size``
slice of a long one): top-k experts per token, the position in each expert
by a cumulative sum, ``slot = expert * C + position``; tokens beyond the
capacity ``C`` are dropped. The kept tokens are gathered into capacity
buffers, each expert's FFN runs on its buffer, and the outputs are combined
back with the renormalised router weights.

The three expert products go through ``models.common.weight_matmul`` with a
3-D expert stack, i.e. the ``grouped_matmul`` kernel on the card (its plain
version on the CPU), wherever the offload plan put the stack: on the device,
or in pinned host memory, streamed over the host link. The reference's
``(B, E, C, d)`` buffers become ``(E, B*C, d)`` here, the layout the kernel
reads: the gather index is permuted (a small integer tensor), so the tokens
land expert-major with no copy of the activations. The decode path (S == 1)
computes every expert densely, as the reference does, through the same
kernel with one shared x (expert stride 0).

On a mesh whose model axis divides the experts (expert parallelism) a rank
holds the stacks of experts ``[e0, e0 + E_local)`` and ``apply_moe`` is
given that range. The routing stays global: every expert's slots are
computed over whole routing groups, so the capacity and the drops are the
unsharded step's. Only the local experts' slots are gathered into
``(E_local, G*C, d)`` buffers, and the combine adds only their
contributions, scattered into the tokens from the slots (its backward a
gather); the caller's exit of the expert region sums the ranks' parts. The
decode path computes only the local experts, weighed by their columns of
the dense routing weights. This takes the place of the reference's
``ep_spec``, whose ``with_sharding_constraint`` calls steer GSPMD to the
same split of the dispatch buffers.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import ParamBuilder, weight_matmul
from repro_torch.models.layers import _act


def init_moe(b: ParamBuilder, *, stacked: bool = False):
    cfg = b.cfg
    L = (cfg.num_layers,) if stacked else ()
    lr = ("none",) if stacked else ()
    E = cfg.num_experts
    b.add("router", L + (cfg.d_model, E), lr + ("d_fsdp", "none"), scale=0.02)
    b.add("w_in", L + (E, cfg.d_model, cfg.d_ff), lr + ("experts", "d_fsdp", "none"))
    if cfg.glu:
        b.add("w_gate", L + (E, cfg.d_model, cfg.d_ff), lr + ("experts", "d_fsdp", "none"))
    b.add("w_out", L + (E, cfg.d_ff, cfg.d_model), lr + ("experts", "none", "d_fsdp"))


def capacity(cfg: ModelConfig, group_tokens: int) -> int:
    c = int(cfg.experts_per_token * group_tokens * cfg.capacity_factor
            // cfg.num_experts)
    return max(c, cfg.experts_per_token)


def _router_probs(p, x):
    """Softmax of the router logits, fp32. x: (..., d)."""
    return torch.softmax(weight_matmul(x.float(), p["router"]), dim=-1)


def _route(cfg: ModelConfig, p, x):
    """(router probabilities (..., E), top-k weights, top-k expert ids), fp32
    throughout, the weights renormalised over the k."""
    probs = _router_probs(p, x)
    top_w, top_e = torch.topk(probs, cfg.experts_per_token, dim=-1,
                              sorted=True)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    return probs, top_w, top_e


def route(cfg: ModelConfig, p, x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Router logits -> (top-k weights, top-k expert ids), both (..., k)."""
    _, top_w, top_e = _route(cfg, p, x)
    return top_w, top_e


def _slots(cfg: ModelConfig, top_w, top_e, C: int):
    """Dispatch of G groups at once. top_*: (G, S, k). Returns (slot_token
    (G, E*C): the token of each capacity slot, S for an empty one; keep_w
    (G, S, k): the weights with dropped assignments zeroed; slot (G, S, k):
    each assignment's slot, E*C where it was dropped)."""
    G, S, k = top_e.shape
    E = cfg.num_experts
    flat_e = top_e.reshape(G, S * k)
    onehot = F.one_hot(flat_e, E)                              # (G, S*k, E)
    pos = ((onehot.cumsum(1) - 1) * onehot).sum(-1)            # pos within expert
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, E * C)          # drop -> pad slot
    token_id = (torch.arange(S * k, device=top_e.device) // k).expand(G, -1)
    # scatter into E*C + 1 slots: every dropped assignment lands on the pad
    # slot E*C (in range), which is cut off; kept slots are unique
    slot_token = torch.full((G, E * C + 1), S, dtype=torch.long,
                            device=top_e.device)
    slot_token.scatter_(1, slot, token_id)
    keep_w = torch.where(keep.reshape(G, S, k), top_w, torch.zeros_like(top_w))
    return slot_token[:, :E * C], keep_w, slot.reshape(G, S, k)


def _dispatch_group(cfg: ModelConfig, x_g, top_w_g, top_e_g, C: int):
    """Per-group dispatch, the reference's. x_g: (S, d); top_*: (S, k).
    Returns (gathered (E*C, d), slot_token (E*C,), keep_w (S, k), slot
    (S, k)); the pad token is row S of ``x_pad``."""
    slot_token, keep_w, slot = _slots(cfg, top_w_g[None], top_e_g[None], C)
    x_pad = torch.cat([x_g, x_g.new_zeros((1, x_g.shape[-1]))], dim=0)
    return x_pad[slot_token[0]], slot_token[0], keep_w[0], slot[0]


def _same(t):
    return t


def apply_moe(cfg: ModelConfig, p, x, *, experts=None, enter=_same):
    """Capacity-dispatch MoE FFN. x: (B, S, d), one group per batch row;
    sequences longer than ``moe_group_size`` are split into routing
    sub-groups when they divide evenly; S == 1 takes the decode path.
    Returns (out (B, S, d), probs, top_e): the output and the routing it
    used, the router probabilities and top-k ids of every token, from which
    ``balance_loss`` builds the aux loss without routing again.

    ``experts``: ``(e0, E_local)``, the experts whose stacks ``p`` holds (a
    rank's share under expert parallelism), or None for all of them. Given
    a range, ``out`` is the sum over those experts alone, and ``enter`` (the
    expert region's entry on a mesh) is applied to the dispatch input and
    the routing weights before they reach the experts; the routing itself
    reads ``x`` as given."""
    B, S, d = x.shape
    if S == 1:
        return _apply_moe_decode(cfg, p, x, experts, enter)
    gs = cfg.moe_group_size
    if S > gs and S % gs == 0:
        out, probs, top_e = _apply_moe_grouped(
            cfg, p, x.reshape(B * (S // gs), gs, d), experts, enter)
        return out.reshape(B, S, d), probs, top_e
    return _apply_moe_grouped(cfg, p, x, experts, enter)


def _expert_ffn(cfg: ModelConfig, p, x):
    """The experts' FFNs on (E, M, d) rows -> (E, M, d)."""
    h = weight_matmul(x, p["w_in"])                            # (E, M, f)
    if cfg.glu:
        h = _act(cfg, weight_matmul(x, p["w_gate"])) * h
    else:
        h = _act(cfg, h)
    return weight_matmul(h, p["w_out"])                        # (E, M, d)


def _apply_moe_grouped(cfg: ModelConfig, p, x, experts=None, enter=_same):
    G, S, d = x.shape
    E = cfg.num_experts
    C = capacity(cfg, S)
    probs, top_w, top_e = _route(cfg, p, x)                    # (G, S, k)
    slot_token, keep_w, slot = _slots(cfg, top_w, top_e, C)
    if experts is not None:
        out = _local_experts(cfg, p, enter(x), enter(keep_w), slot_token,
                             slot, C, experts)
        return out, probs, top_e
    _, _, buffers = _gather_experts(x, slot_token, C, 0, E)
    out_e = _expert_ffn(cfg, p, buffers)
    # combine: out[g, s] = sum_j keep_w[g, s, j] * out_e[slot[g, s, j]], a
    # dropped assignment reading the zero pad row at E*G*C
    e_of, c_of = slot // C, slot % C
    g_of = torch.arange(G, device=x.device)[:, None, None]
    flat = torch.where(slot < E * C, e_of * (G * C) + g_of * C + c_of, E * G * C)
    out_pad = torch.cat([out_e.reshape(E * G * C, d), out_e.new_zeros((1, d))])
    sel = out_pad[flat.reshape(-1)].reshape(G, S, -1, d)       # (G, S, k, d)
    return (sel * keep_w.to(x.dtype)[..., None]).sum(2), probs, top_e


def _gather_experts(x, slot_token, C: int, e0: int, n: int):
    """The capacity buffers of experts ``[e0, e0 + n)``, gathered
    expert-major: row (e, g*C + c) is slot (e0 + e)*C + c of group g, i.e.
    the reference's (G, E, C, d) buffers viewed as (E, G*C, d). x: (G, S,
    d); slot_token: (G, E*C), S for an empty slot. Returns (x_pad (G*(S+1),
    d), the zero row S of each group the pad token; rows (n*G*C,), each
    buffer row's row of x_pad; the buffers (n, G*C, d))."""
    G, S, d = x.shape
    x_pad = torch.cat([x, x.new_zeros((G, 1, d))], dim=1).reshape(G * (S + 1), d)
    base = (torch.arange(G, device=x.device) * (S + 1))[:, None]
    rows = (slot_token[:, e0 * C:(e0 + n) * C] + base).reshape(G, n, C)
    rows = rows.transpose(0, 1).reshape(-1)
    return x_pad, rows, x_pad[rows].reshape(n, G * C, d)


def _local_experts(cfg: ModelConfig, p, x, keep_w, slot_token, slot, C: int,
                   experts):
    """The FFNs of experts ``[e0, e0 + n)`` on their slots of every group
    and their part of the combine. x: (G, S, d); keep_w, slot: (G, S, k);
    slot_token: (G, E*C). Each local slot's output, times the weight of the
    assignment that filled it, is added into its token's row (an empty
    slot reads and writes the pad row S, which is cut off), so the backward
    of the combine is a gather, and no assignment to another rank's expert
    touches a row."""
    G, S, d = x.shape
    e0, n = experts
    E = cfg.num_experts
    # each slot's weight: the kept assignments scattered to their slots (a
    # dropped one, weight 0, to the pad slot E*C)
    w_slot = keep_w.new_zeros((G, E * C + 1)).scatter(
        1, slot.reshape(G, -1), keep_w.reshape(G, -1))[:, e0 * C:(e0 + n) * C]
    x_pad, rows, buffers = _gather_experts(x, slot_token, C, e0, n)
    out_e = _expert_ffn(cfg, p, buffers)
    w_rows = w_slot.reshape(G, n, C).transpose(0, 1).reshape(-1, 1)
    out = x_pad.new_zeros((G * (S + 1), d)).index_add(
        0, rows, out_e.reshape(-1, d) * w_rows.to(x.dtype))
    return out.reshape(G, S + 1, d)[:, :S]


def _apply_moe_decode(cfg: ModelConfig, p, x, experts=None, enter=_same):
    """Dense-all-experts decode path (every expert weight read once); with
    ``experts`` the local ones alone, weighed by their columns."""
    B, S, d = x.shape
    E = cfg.num_experts
    probs, top_w, top_e = _route(cfg, p, x)                    # (B, S, k)
    # dense per-token expert weights: sum_j w_j * onehot(e_j)
    w_full = (top_w[..., None] * F.one_hot(top_e, E).float()).sum(-2)  # (B,S,E)
    n = E
    if experts is not None:
        e0, n = experts
        x, w_full = enter(x), enter(w_full[..., e0:e0 + n])
    out_e = _expert_ffn(cfg, p, x.reshape(1, B * S, d).expand(n, B * S, d))
    w_tok = w_full.reshape(B * S, n).t().to(x.dtype)[..., None]        # (n,BS,1)
    return (out_e * w_tok).sum(0).reshape(B, S, d), probs, top_e


def load_balance_loss(cfg: ModelConfig, p, x) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style): E * sum(f_e * p_e)."""
    probs, _, top_e = _route(cfg, p, x)
    return balance_loss(cfg, probs, top_e)


def _token_mean(t):
    return t.mean(0)


def balance_loss(cfg: ModelConfig, probs, top_e, mean=_token_mean
                 ) -> torch.Tensor:
    """``load_balance_loss`` from a routing already computed: the router
    probabilities (..., E) and top-k ids (..., k) of the same tokens.
    ``mean`` takes rows (N, E) to their mean over the tokens (on a mesh,
    over every rank's tokens)."""
    frac = mean(F.one_hot(top_e, cfg.num_experts).float().reshape(
        -1, cfg.num_experts))
    mean_p = mean(probs.reshape(-1, cfg.num_experts))
    return cfg.num_experts * torch.sum(frac * mean_p)
