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

``make_mesh_train_step(model, mesh, cfg, batch_specs)`` is the reference's
sharded step: the model built on ``mesh`` (``build_model(cfg, mesh)``) runs this
rank's shard, parameters and AdamW moments are ``DTensor``s under the
model's specs (ZeRO-3: each layer gathers its weights and reduce-scatters
their gradients), the batch is laid out by ``batch_specs``, microbatches
split the rank's local batch, and ``grad_compression`` syncs the gradients
over the mesh's ``"pod"`` axis when it has one. As in the reference's build,
the compressed sync runs after the gradients' automatic reduction over
"pod" (the parameters are replicated there).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.models.common import (is_dtensor, placements, shard_local,
                                       tree_leaves, tree_unflatten)
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


def _split_local(x, axis: int, parts: int):
    """A ``DTensor``'s local rows in ``parts`` microbatches, each again a
    ``DTensor`` of 1 / ``parts`` the global batch: the split of the rank's
    local batch."""
    shape = list(x.shape)
    shape[axis] //= parts
    return [shard_local(c, shape, x.placements, x.device_mesh)
            for c in x.to_local().chunk(parts, dim=axis)]


def _accumulate_grads(model: Model, params, batch, microbatches: int):
    """A loop over microbatches; the batch's leading dim must divide evenly
    (``"positions"`` is (3, B, S): batch on axis 1, the M-RoPE streams). On
    a mesh the rank's local batch is split."""
    loss_fn = make_loss_fn(model)
    unread = [params[k] for k in model.unread_params()]
    if microbatches <= 1:
        return _value_and_grad(loss_fn, params, batch, unread)

    def split(name, x):
        axis = 1 if name == "positions" else 0
        b = (x.to_local() if is_dtensor(x) else x).shape[axis]
        if b % microbatches:
            raise ValueError(f"batch dim {b} of {name!r} does not divide into "
                             f"{microbatches} microbatches")
        if is_dtensor(x):
            return _split_local(x, axis, microbatches)
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


def _steps(cfg: TrainStepConfig, grads_of, pods=None):
    """The step around ``grads_of(params, batch) -> (loss, grads)``. With
    ``pods`` (a group or a mesh with a "pod" axis, as
    ``compression.cross_pod_sync`` takes them) the reference's compressed
    step: ``step(params, opt_state, batch, err) -> (params, opt_state,
    metrics, err)``, where ``err`` is the error feedback
    (``compression.init_error_feedback(params)`` at the start) and the
    gradients are the pods' compressed mean."""
    def step(params, opt_state, batch):
        loss, grads = grads_of(params, batch)
        params, opt_state, metrics = adamw.update(cfg.opt, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics

    if pods is None:
        return step

    def compressed_step(params, opt_state, batch, err):
        loss, grads = grads_of(params, batch)
        grads, err = compression.cross_pod_sync(grads, err, pods,
                                                compress=True)
        params, opt_state, metrics = adamw.update(cfg.opt, grads, opt_state,
                                                  params)
        metrics["loss"] = loss
        return params, opt_state, metrics, err
    return compressed_step


def make_train_step(model: Model, cfg: TrainStepConfig, group=None):
    """Returns ``step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` with metrics ``loss``, ``grad_norm`` and ``lr``: one device,
    or the pods as the ranks of ``group``. With ``cfg.grad_compression`` and
    a ``group`` of more than one rank, the compressed step of ``_steps``."""
    compress = (cfg.grad_compression and group is not None
                and dist.get_world_size(group) > 1)
    return _steps(cfg, lambda params, batch: _accumulate_grads(
        model, params, batch, cfg.microbatches), group if compress else None)


def _lay_out(batch, mesh, batch_specs, env):
    """Each input as a ``DTensor`` laid out by its spec on ``mesh``."""
    from torch.distributed.tensor import distribute_tensor
    out = {}
    for name, x in batch.items():
        pl = placements(batch_specs[name], env)
        if not is_dtensor(x):
            x = distribute_tensor(x, mesh, pl)
        elif tuple(x.placements) != pl:
            x = x.redistribute(mesh, pl)
        out[name] = x
    return out


def make_mesh_train_step(model: Model, mesh, cfg: TrainStepConfig,
                         batch_specs):
    """The reference's sharded step on ``mesh`` (see the module's
    docstring): ``make_train_step``'s step, with the compressed one when
    ``cfg.grad_compression`` and the mesh has a "pod" axis.
    ``batch_specs`` maps each input to its spec (``Model.batch_specs``'
    third field); a batch leaf laid out otherwise is redistributed first,
    as the reference's ``in_shardings`` would."""
    if model.env.mesh is not mesh:
        raise ValueError("the model was not built on this mesh: "
                         "build_model(cfg, mesh)")
    compress = cfg.grad_compression and "pod" in mesh.mesh_dim_names

    def grads_of(params, batch):
        batch = _lay_out(batch, mesh, batch_specs, model.env)
        return _accumulate_grads(model, params, batch, cfg.microbatches)
    return _steps(cfg, grads_of, mesh if compress else None)


def make_eval_step(model: Model, mesh=None, batch_specs=None):
    """``step(params, batch) -> loss``; with ``mesh`` and ``batch_specs``,
    the batch is laid out by its specs first (the reference's sharded eval
    step)."""
    @torch.no_grad()
    def step(params, batch) -> torch.Tensor:
        if mesh is not None:
            batch = _lay_out(batch, mesh, batch_specs, model.env)
        return model.loss_fn(params, batch)
    return step


def metrics_to_floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Python numbers of a step's metrics (waits for the step to finish)."""
    return {k: float(v) for k, v in metrics.items()}
