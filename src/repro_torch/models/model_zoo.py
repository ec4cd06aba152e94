"""Unified model API of the port (dense decoder-only family so far).

``Model`` wires a ModelConfig to (init, forward, decode, caches) on one
device. Where the reference took a mesh or an axis environment, ``Model``
takes ``device`` (default CUDA; the tests pass ``"cpu"``).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Optional, Tuple

import torch

from repro_torch.configs.base import ENCDEC, ModelConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.common import resolve_device, tree_leaves

PyTree = Any


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    device: torch.device

    def _check_family(self):
        if self.cfg.family == ENCDEC:
            raise NotImplementedError(
                f"{self.cfg.name}: encoder-decoder family is not ported yet "
                f"(ROADMAP queue A item 11)")

    # ------------------------------------------------------------------
    def init(self, generator: Optional[torch.Generator] = None, *,
             abstract: bool = False) -> Tuple[PyTree, PyTree]:
        """Returns (params, role tree). ``generator`` must live on the
        model's device; ``abstract=True`` gives meta tensors (no memory)."""
        self._check_family()
        return tfm.init_decoder_only(self.cfg, generator, self.device,
                                     abstract=abstract)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def forward(self, params, batch, *, return_cache: bool = False,
                last_token_only: bool = False):
        self._check_family()
        return tfm.forward_decoder_only(
            self.cfg, params, batch, return_cache=return_cache,
            last_token_only=last_token_only)

    @torch.no_grad()
    def decode(self, params, cache, batch):
        """Updates ``cache`` in place and returns it with the logits."""
        self._check_family()
        return tfm.decode_decoder_only(self.cfg, params, cache, batch)

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, dtype=torch.bfloat16,
                   device=None):
        self._check_family()
        return tfm.init_cache_decoder_only(
            self.cfg, batch, max_seq, dtype,
            device=self.device if device is None else device)

    def cache_shapes(self, batch: int, max_seq: int, dtype=torch.bfloat16):
        """The cache tree as meta tensors: shapes and dtypes, no memory."""
        return self.init_cache(batch, max_seq, dtype, device="meta")

    def cache_bytes(self, batch: int, max_seq: int, dtype=torch.bfloat16) -> int:
        """KV pool footprint without allocating it."""
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


def build_model(cfg: ModelConfig, device="cuda") -> Model:
    return Model(cfg=cfg, device=resolve_device(device))
