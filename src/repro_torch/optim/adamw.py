"""AdamW with a cosine schedule and global-norm clipping, over nested dicts.

The reference's values (``repro/optim/adamw.py``). The reference returns new
trees; here ``update`` writes the parameters and moments **in place** under
``torch.no_grad()`` and returns the same trees, which saves a copy of the
model and its two moments per step. Moments are fp32 whatever the parameter
dtype; the arithmetic of one update is the reference's, in fp32. Scalars of
the step (clip scale, learning rate) stay 0-d tensors on the parameters'
device, so an update never waits for the card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten

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


def init(params: PyTree) -> AdamWState:
    leaves = list(tree_leaves(params))
    zeros = lambda: tree_unflatten(params, [
        torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves])
    return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                       device=leaves[0].device),
                      mu=zeros(), nu=zeros())


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Learning rate at ``step`` (an int or a 0-d tensor): linear warm-up,
    then cosine decay to ``min_lr_ratio`` of ``lr``; fp32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tree: PyTree) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree_leaves(tree)))


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
        g = g.float() * scale
        m.mul_(cfg.beta1).add_((1 - cfg.beta1) * g)
        v.mul_(cfg.beta2).add_((1 - cfg.beta2) * g.square())
        step_vec = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        p32 = p.float()
        p.copy_(p32 - lr * (step_vec + cfg.weight_decay * p32))
    state.step.copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
