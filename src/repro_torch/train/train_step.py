"""Train-step factory: microbatched gradient accumulation and AdamW.

The reference builds one jit'd function with shardings and donated buffers;
on one device both drop out, and the step is a plain function
    step(params, opt_state, batch) -> (params, opt_state, metrics)
that updates ``params`` and ``opt_state`` in place (``adamw.update``) and
returns them. Metrics are 0-d tensors on the device; a caller that needs
Python numbers reads them (and so waits for the step).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch

from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw

PyTree = Any


@dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1
    grad_compression: bool = False   # int8+EF across the pod axis
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)


def make_loss_fn(model: Model):
    def loss_fn(params, batch):
        return model.loss_fn(params, batch)
    return loss_fn


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads) with grads in the structure of ``params``. The
    parameters enter autograd as fresh leaves that share their storage, so
    the caller's tensors are left as they were."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(params, grads)


def _accumulate_grads(model: Model, params, batch, microbatches: int):
    """A loop over microbatches; the batch's leading dim must divide evenly
    (``"positions"`` is (3, B, S): batch on axis 1, the M-RoPE streams)."""
    loss_fn = make_loss_fn(model)
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch)

    def split(name, x):
        axis = 1 if name == "positions" else 0
        b = x.shape[axis]
        if b % microbatches:
            raise ValueError(f"batch dim {b} of {name!r} does not divide into "
                             f"{microbatches} microbatches")
        return x.chunk(microbatches, dim=axis)

    parts = {k: split(k, v) for k, v in batch.items()}
    loss_acc, grads_acc = None, None
    for i in range(microbatches):
        loss, grads = _value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in parts.items()})
        if grads_acc is None:
            loss_acc, grads_acc = loss.float(), [g.float() for g in tree_leaves(grads)]
        else:
            loss_acc = loss_acc + loss
            for acc, g in zip(grads_acc, tree_leaves(grads)):
                acc += g
    scale = 1.0 / microbatches
    return loss_acc * scale, tree_unflatten(params, [g * scale for g in grads_acc])


def make_train_step(model: Model, cfg: TrainStepConfig):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``."""
    if cfg.grad_compression:
        raise NotImplementedError(
            "grad_compression (int8 + error feedback across pods) is not "
            "ported yet: ROADMAP queue A item 12")

    def step(params, opt_state, batch):
        loss, grads = _accumulate_grads(model, params, batch, cfg.microbatches)
        params, opt_state, metrics = adamw.update(cfg.opt, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics
    return step


def make_eval_step(model: Model):
    @torch.no_grad()
    def step(params, batch) -> torch.Tensor:
        return model.loss_fn(params, batch)
    return step


def metrics_to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Python numbers of a step's metrics (waits for the step to finish)."""
    return {k: float(v) for k, v in metrics.items()}
