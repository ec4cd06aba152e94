"""Unified model API of the port over all families: the decoder-only ones
(dense, MoE, VLM, SSM, hybrid; ``models/transformer.py``) and the
encoder-decoder (``models/encdec.py``), dispatched on ``cfg.family`` as in
the reference.

``Model`` wires a ModelConfig to (init, forward, loss, decode, caches) and
to the reference's sharding specs (``batch_specs``, ``cache_specs``,
``input_specs``, ``abstract_params``). ``build_model`` takes a device (one
device: the default CUDA, the tests pass ``"cpu"``), a ``DeviceMesh`` (the
model runs as this rank's shard of the mesh: parameters, batch and cache
are ``DTensor``s) or an ``AxisEnv`` (specs only, as the reference's
``build_model(cfg, env)``).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig
from repro_torch.configs.shapes import DECODE, TRAIN, ShapeSuite
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (AxisEnv, ShardingPolicy,
                                       host_axis_env, make_policy, placements,
                                       pspec, resolve_device, shard_local,
                                       tree_items,
                                       tree_leaves, tree_unflatten)
from repro_torch.models.layers import softmax_xent  # noqa: F401

PyTree = Any


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device
    env: AxisEnv = field(default_factory=host_axis_env)
    pol: Optional[ShardingPolicy] = None

    def __post_init__(self):
        if self.pol is None:
            object.__setattr__(self, "pol", make_policy(self.cfg, self.env))

    @property
    def sharded(self) -> bool:
        """True when the model runs as one rank's shard of a mesh."""
        return self.env.sharded

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             abstract: bool = False,
             placement: Optional[Dict[str, str]] = None
             ) -> Tuple[PyTree, PyTree]:
        """Returns (params, role tree). ``generator`` must live on the
        model's device; ``abstract=True`` gives meta tensors (no memory).
        ``placement`` (parameter path -> memory kind, from
        ``core.offload.param_placement`` on the abstract tree) draws each
        leaf straight into its tier: bit for bit ``init`` followed by
        ``place_tree``, without the whole tree on the device first."""
        init = (encdec_mod.init_encdec if self.cfg.family == ENCDEC
                else tfm.init_decoder_only)
        return init(self.cfg, generator, self.device, abstract=abstract,
                    placement=placement, pol=self.pol, env=self.env)

    def abstract_params(self, mesh=None) -> Tuple[PyTree, PyTree]:
        """(meta tensors, spec tree): no memory. With ``mesh``, each leaf is
        paired with its placements there: ``(meta tensor, placements)``."""
        shapes, specs = self.init(abstract=True)
        if mesh is None:
            return shapes, specs
        env = AxisEnv.from_mesh(mesh)
        leaves = [(x, placements(sp, env)) for x, sp in zip(
            tree_leaves(shapes), _spec_leaves(specs))]
        return tree_unflatten(shapes, leaves), specs

    # ------------------------------------------------------------------
    def _run(self, batch, *, decode: bool = False):
        """The hooks of this call: None (one device), or on a mesh the
        ``MeshRun`` that lays out this batch."""
        if not self.sharded:
            return None
        return tfm.MeshRun(self.cfg, self.env, self.pol, batch, decode=decode)

    def _forward(self, params, batch, *, return_cache: bool = False,
                 last_token_only: bool = False, with_loss: bool = False):
        forward = (encdec_mod.forward_encdec if self.cfg.family == ENCDEC
                   else tfm.forward_decoder_only)
        return forward(self.cfg, params, batch, return_cache=return_cache,
                       last_token_only=last_token_only, run=self._run(batch),
                       with_loss=with_loss)

    @torch.no_grad()
    def forward(self, params, batch, *, return_cache: bool = False,
                last_token_only: bool = False):
        return self._forward(params, batch, return_cache=return_cache,
                             last_token_only=last_token_only)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy plus 0.01 x the auxiliary loss, with
        autograd on (the serving ``forward`` runs without it)."""
        loss, aux, _ = self._forward(params, batch, with_loss=True)
        return loss + 0.01 * aux

    def unread_params(self) -> Tuple[str, ...]:
        """Top-level names of the parameters ``loss_fn`` never reads: the
        VLM's token table when the head is untied (its inputs are
        embeddings)."""
        if self.cfg.family == VLM and not self.cfg.tie_embeddings:
            return ("tok_embed",)
        return ()

    @torch.no_grad()
    def decode(self, params, cache, batch):
        """Updates ``cache`` in place and returns it with the logits."""
        decode = (encdec_mod.decode_encdec if self.cfg.family == ENCDEC
                  else tfm.decode_decoder_only)
        return decode(self.cfg, params, cache, batch,
                      run=self._run(batch, decode=True))

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
        """The zero cache; on a mesh, this rank's shard of it as
        ``DTensor``s laid out by ``cache_specs`` (only the local shard is
        allocated)."""
        init_cache = (encdec_mod.init_cache_encdec if self.cfg.family == ENCDEC
                      else tfm.init_cache_decoder_only)
        if self.sharded and device is None:
            return self._sharded_cache(batch, max_seq, dtype)
        return init_cache(self.cfg, batch, max_seq, dtype,
                          device=self.device if device is None else device)

    def _sharded_cache(self, batch: int, max_seq: int, dtype):
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        shapes = self.cache_shapes(batch, max_seq, dtype)
        out = []
        for x, sp in zip(tree_leaves(shapes), _spec_leaves(self.cache_specs(batch))):
            pl = placements(sp, self.env)
            shape, _ = compute_local_shape_and_global_offset(
                x.shape, self.env.mesh, pl)
            out.append(shard_local(torch.zeros(shape, dtype=x.dtype,
                                               device=self.device),
                                   x.shape, pl, self.env.mesh))
        return tree_unflatten(shapes, out)

    def cache_specs(self, batch: int) -> PyTree:
        if self.cfg.family == ENCDEC:
            return encdec_mod.cache_specs_encdec(self.cfg, batch, self.env,
                                                 self.pol)
        return tfm.cache_specs_decoder_only(self.cfg, batch, self.env,
                                            self.pol)

    def abstract_cache(self, batch: int, max_seq: int, mesh=None,
                       dtype=torch.bfloat16) -> PyTree:
        """The cache as meta tensors; with ``mesh``, each leaf paired with
        its placements there."""
        shapes = self.cache_shapes(batch, max_seq, dtype)
        if mesh is None:
            return shapes
        env = AxisEnv.from_mesh(mesh)
        return tree_unflatten(shapes, [
            (x, placements(sp, env)) for x, sp in zip(
                tree_leaves(shapes), _spec_leaves(self.cache_specs(batch)))])

    def cache_shapes(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        """The cache tree as meta tensors: shapes and each leaf's own dtype
        (an SSM state is fp32 in a ``dtype`` pool), no memory."""
        return self.init_cache(batch, max_seq, dtype, device="meta")

    def cache_bytes(self, batch: int, max_seq: int, dtype=torch.bfloat16) -> int:
        """KV/state pool footprint without allocating it, each leaf at its
        own dtype."""
        return sum(x.numel() * x.element_size()
                   for x in tree_leaves(self.cache_shapes(batch, max_seq, dtype)))

    # ------------------------------------------------------------------
    def serving_inventory(self, params: PyTree, cache: PyTree):
        """TensorInfo inventory of this tenant's real serving state.

        Leaf paths are prefixed ``params/`` and ``kv/`` so the same names
        flow from the plan into ``KVPool`` placement. KV leaves are divisible
        (the pool spills a cold tail of the sequence axis) and so are
        embedding tables (row granularity). ``cache`` may be meta tensors.
        """
        from repro_torch.core.offload import TensorInfo, inventory_from_tree
        inv = inventory_from_tree({"params": params, "kv": cache})
        out = []
        for t in inv:
            if t.name.startswith("kv/"):
                t = TensorInfo(t.name, t.bytes, "kv_cache",
                               offloadable=True, divisible=True)
            elif t.group == "embed":
                t = replace(t, divisible=True)
            out.append(t)
        return out

    # ------------------------------------------------------------------
    def batch_specs(self, shape: ShapeSuite) -> Dict[str, Tuple]:
        """(shape, dtype, spec) per input: the single source of truth for
        ``input_specs`` and for synthetic batches. The specs are the
        reference's (the fsdp_only profile's batch on the joint axes; the
        sequence on the model axis when activations are sequence-sharded)."""
        cfg, env = self.cfg, self.env
        B = shape.global_batch
        S = 1 if shape.kind == DECODE else shape.seq_len
        if self.pol.profile == "fsdp_only":
            baxes = env.batch_axes_joint(B)
        else:
            baxes = env.batch_axes(B)
        seq_ax = env.tp if (self.pol.seq_sharded_acts and shape.kind != DECODE) else None
        out: Dict[str, Tuple] = {}
        if cfg.family == VLM:
            out["embeds"] = ((B, S, cfg.d_model), torch.bfloat16,
                             pspec(baxes, seq_ax, None))
            out["positions"] = ((3, B, S), torch.int32, pspec(None, baxes, None))
        elif cfg.family == ENCDEC:
            if shape.kind != DECODE:
                out["frames"] = ((B, cfg.encoder_seq, cfg.d_model),
                                 torch.bfloat16, pspec(baxes, None, None))
            out["tokens"] = ((B, S), torch.int32, pspec(baxes, None))
        else:
            out["tokens"] = ((B, S), torch.int32, pspec(baxes, seq_ax))
        if shape.kind == TRAIN:
            out["labels"] = ((B, S), torch.int32, pspec(baxes, seq_ax))
        if shape.kind == DECODE:
            out["pos"] = ((), torch.int32, pspec())
        return out

    def input_specs(self, shape: ShapeSuite, mesh=None) -> Dict[str, Any]:
        """Meta tensors of every input (no memory); with ``mesh``, each
        paired with its placements there."""
        out = {}
        for name, (shp, dt, sp) in self.batch_specs(shape).items():
            x = torch.empty(shp, dtype=dt, device="meta")
            out[name] = x if mesh is None else (
                x, placements(sp, AxisEnv.from_mesh(mesh)))
        return out

    def synthetic_batch(self, shape: ShapeSuite,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        """Random inputs of ``batch_specs(shape)`` on the model's device:
        token ids uniform over the vocabulary, floats 0.02 x normal, ``pos``
        zero. ``generator`` (on the model's device) makes them repeatable."""
        if self.sharded:
            return self._sharded_batch(shape, generator)
        out = {}
        for name, (shp, dt, _) in self.batch_specs(shape).items():
            if dt == torch.int32:
                hi = self.cfg.vocab_size if name in ("tokens", "labels") else max(
                    1, min(shp[-1] if shp else 1, 4096))
                out[name] = (torch.zeros(shp, dtype=dt, device=self.device)
                             if not shp else
                             torch.randint(0, hi, shp, generator=generator,
                                           dtype=dt, device=self.device))
            else:
                out[name] = 0.02 * torch.randn(shp, generator=generator,
                                               device=self.device).to(dt)
        if "pos" in out:
            out["pos"] = torch.zeros((), dtype=torch.int32, device=self.device)
        return out


    def _sharded_batch(self, shape: ShapeSuite,
                       generator: Optional[torch.Generator]):
        """This rank's shard of a synthetic batch as ``DTensor``s: each rank
        draws its own local rows (the values differ from an unsharded
        batch of the same seed)."""
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)
        out = {}
        for name, (shp, dt, sp) in self.batch_specs(shape).items():
            pl = placements(sp, self.env)
            lshape, _ = compute_local_shape_and_global_offset(
                shp, self.env.mesh, pl)
            if name == "pos":
                x = torch.zeros((), dtype=dt, device=self.device)
            elif dt == torch.int32:
                hi = self.cfg.vocab_size if name in ("tokens", "labels") else max(
                    1, min(shp[-1] if shp else 1, 4096))
                x = torch.randint(0, hi, tuple(lshape), generator=generator,
                                  dtype=dt, device=self.device)
            else:
                x = 0.02 * torch.randn(tuple(lshape), generator=generator,
                                       device=self.device).to(dt)
            out[name] = shard_local(x, shp, pl, self.env.mesh)
        return out


def shard_tree(tree: PyTree, specs: PyTree, env: AxisEnv) -> PyTree:
    """Full tensors (the same on every rank) -> ``DTensor``s laid out by
    ``specs`` on ``env``'s mesh, each rank keeping its own shard: how a test
    hands a sharded model the reference's weights or an unsharded batch."""
    from torch.distributed.tensor import distribute_tensor
    return tree_unflatten(tree, [
        distribute_tensor(x, env.mesh, placements(sp, env))
        for x, sp in zip(tree_leaves(tree), _spec_leaves(specs))])


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and not hasattr(x, "_fields") and all(
        e is None or isinstance(e, (str, tuple)) for e in x)


def _spec_leaves(specs: PyTree):
    """The specs of a spec tree in ``tree_leaves`` order (a spec is a tuple,
    so it is a leaf here, not a node)."""
    if _is_spec(specs):
        yield specs
        return
    for _, child in tree_items(specs):
        yield from _spec_leaves(child)


def build_model(cfg: ModelConfig, device_or_mesh_or_env="cuda") -> Model:
    """A model on one device (a device or its name; default CUDA), as this
    rank's shard of a ``DeviceMesh``, or with an ``AxisEnv``'s specs (no
    mesh: the model computes on the CPU, unsharded, and its spec trees are
    the env's)."""
    target = device_or_mesh_or_env
    if isinstance(target, AxisEnv):
        device = (torch.device("cpu") if target.mesh is None
                  else resolve_device(target.mesh.device_type))
        return Model(cfg=cfg, device=device, env=target)
    if hasattr(target, "mesh_dim_names"):
        return Model(cfg=cfg, device=resolve_device(target.device_type),
                     env=AxisEnv.from_mesh(target))
    return Model(cfg=cfg, device=resolve_device(target))
