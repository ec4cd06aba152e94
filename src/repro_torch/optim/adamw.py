"""AdamW with a cosine schedule and global-norm clipping, over nested dicts.

The reference's values (``repro/optim/adamw.py``). The reference returns new
trees; here ``update`` writes the parameters and moments **in place** under
``torch.no_grad()`` and returns the same trees, which saves a copy of the
model and its two moments per step. Moments are fp32 whatever the parameter
dtype; the arithmetic of one update is the reference's, in fp32. Scalars of
the step (clip scale, learning rate) stay 0-d tensors on the parameters'
device, so an update never waits for the card.

On a mesh the parameters, gradients and moments are ``DTensor``s with the
same placements (the moments shard with their parameters: ``state_specs``);
the global norm sums each leaf over the mesh, and the update itself is
element-wise on each rank's local shards.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.common import (is_dtensor, local, pspec, tree_leaves,
                                       tree_unflatten)

PyTree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    mu: PyTree
    nu: PyTree


def _zeros(p):
    if is_dtensor(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: PyTree) -> AdamWState:
    leaves = list(tree_leaves(params))
    zeros = lambda: tree_unflatten(params, [_zeros(p) for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=local(leaves[0]).device),
                      mu=zeros(), nu=zeros())


def state_specs(param_specs: PyTree) -> AdamWState:
    """Partition specs mirroring ``init``'s structure: the moments shard
    with their parameters, the step is replicated."""
    return AdamWState(step=pspec(), mu=param_specs, nu=param_specs)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor): linear warm-up,
    then cosine decay to ``min_lr_ratio`` of ``lr``; fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def _square_sum(x) -> torch.Tensor:
    sq = x.float().square().sum()
    return sq.full_tensor() if is_dtensor(sq) else sq


def global_norm(tree: PyTree) -> torch.Tensor:
    """The L2 norm over every leaf; a ``DTensor`` leaf is summed over the
    whole mesh (a plain 0-d tensor results)."""
    return torch.sqrt(sum(_square_sum(x) for x in tree_leaves(tree)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: PyTree, state: AdamWState, params: PyTree
           ) -> Tuple[PyTree, AdamWState, dict]:
    """One AdamW step, in place: returns (params, state, metrics) with the
    same trees it was given, updated. ``grads`` has the structure of
    ``params``."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, state.step).to(gnorm.device)
    b1c = 1 - cfg.beta1 ** step.float()
    b2c = 1 - cfg.beta2 ** step.float()
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu), tree_leaves(params)):
        if is_dtensor(p):
            if not (g.placements == m.placements == v.placements == p.placements):
                raise ValueError(f"a gradient or moment is not laid out as "
                                 f"its parameter: {g.placements} "
                                 f"{m.placements} {p.placements}")
            g, m, v, p = g.to_local(), m.to_local(), v.to_local(), p.to_local()
        g = g.float() * scale
        m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g.square())
        step_vec = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step_vec + cfg.weight_decay * p32))
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
