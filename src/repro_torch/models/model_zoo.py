"""Unified model API of the port over all families: the decoder-only ones
(dense, MoE, VLM, SSM, hybrid; ``models/transformer.py``) and the
encoder-decoder (``models/encdec.py``), dispatched on ``cfg.family`` as in
the reference.

``Model`` wires a ModelConfig to (init, forward, loss, decode, caches) on one
device. Where the reference took a mesh or an axis environment, ``Model``
takes ``device`` (default CUDA; the tests pass ``"cpu"``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ENCDEC, VLM, ModelConfig
from repro_torch.configs.shapes import DECODE, TRAIN, ShapeSuite
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device, tree_leaves

PyTree = Any


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

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
                    placement=placement)

    # ------------------------------------------------------------------
    def _forward(self, params, batch, *, return_cache: bool = False,
                 last_token_only: bool = False):
        forward = (encdec_mod.forward_encdec if self.cfg.family == ENCDEC
                   else tfm.forward_decoder_only)
        return forward(self.cfg, params, batch, return_cache=return_cache,
                       last_token_only=last_token_only)

    @torch.no_grad()
    def forward(self, params, batch, *, return_cache: bool = False,
                last_token_only: bool = False):
        return self._forward(params, batch, return_cache=return_cache,
                             last_token_only=last_token_only)

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy plus 0.01 x the auxiliary loss, with
        autograd on (the serving ``forward`` runs without it)."""
        logits, aux, _ = self._forward(params, batch)
        return softmax_xent(logits, batch["labels"]) + 0.01 * aux

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
        return decode(self.cfg, params, cache, batch)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
        init_cache = (encdec_mod.init_cache_encdec if self.cfg.family == ENCDEC
                      else tfm.init_cache_decoder_only)
        return init_cache(self.cfg, batch, max_seq, dtype,
                          device=self.device if device is None else device)

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
        """(shape, dtype) per input of a step of ``shape`` (one device, so
        no partition specs)."""
        cfg = self.cfg
        B = shape.global_batch
        S = 1 if shape.kind == DECODE else shape.seq_len
        out: Dict[str, Tuple] = {}
        if cfg.family == VLM:
            out["embeds"] = ((B, S, cfg.d_model), torch.bfloat16)
            out["positions"] = ((3, B, S), torch.int32)
        elif cfg.family == ENCDEC:
            if shape.kind != DECODE:
                out["frames"] = ((B, cfg.encoder_seq, cfg.d_model), torch.bfloat16)
            out["tokens"] = ((B, S), torch.int32)
        else:
            out["tokens"] = ((B, S), torch.int32)
        if shape.kind == TRAIN:
            out["labels"] = ((B, S), torch.int32)
        if shape.kind == DECODE:
            out["pos"] = ((), torch.int32)
        return out

    def synthetic_batch(self, shape: ShapeSuite,
                        generator: Optional[torch.Generator] = None
                        ) -> Dict[str, torch.Tensor]:
        """Random inputs of ``batch_specs(shape)`` on the model's device:
        token ids uniform over the vocabulary, floats 0.02 x normal, ``pos``
        zero. ``generator`` (on the model's device) makes them repeatable."""
        out = {}
        for name, (shp, dt) in self.batch_specs(shape).items():
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


def softmax_xent(logits, labels) -> torch.Tensor:
    """Mean token cross-entropy, fp32 inside. The reference contracts the
    logits with a one-hot of the labels, a form that stays local when the
    vocabulary is sharded; on one device a gather of the label's logit is the
    same value without materialising the (B, S, V) one-hot."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long()[..., None])[..., 0]
    return (lse - ll).mean()


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg=cfg, device=resolve_device(device))
