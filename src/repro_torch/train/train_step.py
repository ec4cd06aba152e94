"""Train-step factory: microbatched gradient accumulation and AdamW.

The reference builds one jit'd function with shardings and donated buffers;
on one device both drop out, and the step is a plain function
    step(params, opt_state, batch) -> (params, opt_state, metrics)
that updates ``params`` and ``opt_state`` in place (``adamw.update``) and
returns them. Metrics are 0-d tensors on the device; a caller that needs
Python numbers reads them (and so waits for the step).

``grad_compression`` compresses the gradients' cross-pod mean to int8 with
error feedback (``optim.compression.cross_pod_sync``). The reference does so
only when its mesh has a ``"pod"`` axis; here the pods are the ranks of a
``torch.distributed`` group handed to ``make_train_step``. With no group, or
a group of one rank (one device), the step is the plain one, as the
reference's is without a ``"pod"`` axis.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.models.common import tree_leaves, tree_unflatten
from repro_torch.models.model_zoo import Model
from repro_torch.optim import adamw, compression

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


def _value_and_grad(loss_fn, params, batch, unread=()):
    """(loss, grads) with grads in the structure of ``params``. The
    parameters enter autograd as fresh leaves that share their storage, so
    the caller's tensors are left as they were. A parameter in ``unread``
    (``Model.unread_params``: the VLM's token table, whose inputs are
    embeddings) gets a zero gradient, as ``jax.grad`` gives it; any other
    parameter the loss does not read raises."""
    originals = list(tree_leaves(params))
    leaves = [p.detach().requires_grad_() for p in originals]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    allowed = {id(p) for p in unread}
    for i, (p, g) in enumerate(zip(originals, grads)):
        if g is None and id(p) not in allowed:
            raise RuntimeError(f"parameter {i} {tuple(p.shape)} is not read "
                               f"by the loss")
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def _accumulate_grads(model: Model, params, batch, microbatches: int):
    """A loop over microbatches; the batch's leading dim must divide evenly
    (``"positions"`` is (3, B, S): batch on axis 1, the M-RoPE streams)."""
    loss_fn = make_loss_fn(model)
    unread = [params[k] for k in model.unread_params()]
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch, unread)

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
                                      {k: v[i] for k, v in parts.items()},
                                      unread)
        if grads_acc is None:
            loss_acc, grads_acc = loss.float(), [g.float() for g in tree_leaves(grads)]
        else:
            loss_acc = loss_acc + loss
            for acc, g in zip(grads_acc, tree_leaves(grads)):
                acc += g
    scale = 1.0 / microbatches
    return loss_acc * scale, tree_unflatten(params, [g * scale for g in grads_acc])


def make_train_step(model: Model, cfg: TrainStepConfig, group=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``. With
    ``cfg.grad_compression`` and a ``group`` of more than one rank, the
    reference's compressed step: ``step(params, opt_state, batch, err) ->
    (params, opt_state, metrics, err)``, where ``err`` is the error
    feedback (``compression.init_error_feedback(params)`` at the start) and
    the gradients are the ranks' compressed mean."""
    if (cfg.grad_compression and group is not None
            and dist.get_world_size(group) > 1):
        def compressed_step(params, opt_state, batch, err):
            loss, grads = _accumulate_grads(model, params, batch,
                                            cfg.microbatches)
            grads, err = compression.cross_pod_sync(grads, err, group,
                                                    compress=True)
            params, opt_state, metrics = adamw.update(cfg.opt, grads,
                                                      opt_state, params)
            metrics["loss"] = loss
            return params, opt_state, metrics, err
        return compressed_step

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
