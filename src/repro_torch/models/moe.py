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

One device holds every expert, so the reference's ``ep_spec`` /
``moe_ep_spec`` and its ``with_sharding_constraint`` calls, which only steer
GSPMD's sharding of the dispatch buffers, have nothing to do here and are
left out.
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


def apply_moe(cfg: ModelConfig, p, x):
    """Capacity-dispatch MoE FFN. x: (B, S, d), one group per batch row;
    sequences longer than ``moe_group_size`` are split into routing
    sub-groups when they divide evenly; S == 1 takes the decode path.
    Returns (out (B, S, d), probs, top_e): the output and the routing it
    used, the router probabilities and top-k ids of every token, from which
    ``balance_loss`` builds the aux loss without routing again."""
    B, S, d = x.shape
    if S == 1:
        return _apply_moe_decode(cfg, p, x)
    gs = cfg.moe_group_size
    if S > gs and S % gs == 0:
        out, probs, top_e = _apply_moe_grouped(
            cfg, p, x.reshape(B * (S // gs), gs, d))
        return out.reshape(B, S, d), probs, top_e
    return _apply_moe_grouped(cfg, p, x)


def _expert_ffn(cfg: ModelConfig, p, x):
    """The experts' FFNs on (E, M, d) rows -> (E, M, d)."""
    h = weight_matmul(x, p["w_in"])                            # (E, M, f)
    if cfg.glu:
        h = _act(cfg, weight_matmul(x, p["w_gate"])) * h
    else:
        h = _act(cfg, h)
    return weight_matmul(h, p["w_out"])                        # (E, M, d)


def _apply_moe_grouped(cfg: ModelConfig, p, x):
    G, S, d = x.shape
    E = cfg.num_experts
    C = capacity(cfg, S)
    probs, top_w, top_e = _route(cfg, p, x)                    # (G, S, k)
    slot_token, keep_w, slot = _slots(cfg, top_w, top_e, C)
    # gather expert-major: row (e, g*C + c) of the buffers is slot e*C + c of
    # group g, i.e. the reference's (G, E, C, d) buffers viewed as (E, G*C, d)
    x_pad = torch.cat([x, x.new_zeros((G, 1, d))], dim=1).reshape(G * (S + 1), d)
    base = (torch.arange(G, device=x.device) * (S + 1))[:, None]
    rows = (slot_token + base).reshape(G, E, C).transpose(0, 1).reshape(-1)
    out_e = _expert_ffn(cfg, p, x_pad[rows].reshape(E, G * C, d))
    # combine: out[g, s] = sum_j keep_w[g, s, j] * out_e[slot[g, s, j]], a
    # dropped assignment reading the zero pad row at E*G*C
    e_of, c_of = slot // C, slot % C
    g_of = torch.arange(G, device=x.device)[:, None, None]
    flat = torch.where(slot < E * C, e_of * (G * C) + g_of * C + c_of, E * G * C)
    out_pad = torch.cat([out_e.reshape(E * G * C, d), out_e.new_zeros((1, d))])
    sel = out_pad[flat.reshape(-1)].reshape(G, S, -1, d)       # (G, S, k, d)
    return (sel * keep_w.to(x.dtype)[..., None]).sum(2), probs, top_e


def _apply_moe_decode(cfg: ModelConfig, p, x):
    """Dense-all-experts decode path (every expert weight read once)."""
    B, S, d = x.shape
    E = cfg.num_experts
    probs, top_w, top_e = _route(cfg, p, x)                    # (B, S, k)
    # dense per-token expert weights: sum_j w_j * onehot(e_j)
    w_full = (top_w[..., None] * F.one_hot(top_e, E).float()).sum(-2)  # (B,S,E)
    out_e = _expert_ffn(cfg, p, x.reshape(1, B * S, d).expand(E, B * S, d))
    w_tok = w_full.reshape(B * S, E).t().to(x.dtype)[..., None]        # (E,BS,1)
    return (out_e * w_tok).sum(0).reshape(B, S, d), probs, top_e


def load_balance_loss(cfg: ModelConfig, p, x) -> torch.Tensor:
    """Auxiliary load-balancing loss (Switch-style): E * sum(f_e * p_e)."""
    probs, _, top_e = _route(cfg, p, x)
    return balance_loss(cfg, probs, top_e)


def balance_loss(cfg: ModelConfig, probs, top_e) -> torch.Tensor:
    """``load_balance_loss`` from a routing already computed: the router
    probabilities (..., E) and top-k ids (..., k) of the same tokens."""
    frac = F.one_hot(top_e, cfg.num_experts).float().reshape(
        -1, cfg.num_experts).mean(0)
    mean_p = probs.reshape(-1, cfg.num_experts).mean(0)
    return cfg.num_experts * torch.sum(frac * mean_p)
