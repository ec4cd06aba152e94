"""TenantEngine — one tenant's continuous-batching engine over a KVPool.

The refactored core of the old ``ServingEngine``: prefill and decode are
separate paths (``prefill`` writes one request's KV prefix into a pool
slot; ``tick`` advances ALL live slots with one fused ragged decode step),
requests queue behind an admission-control bound, and eviction at the pool
boundary records the partial generation instead of dropping the request —
a truncated answer is still an answer the tenant must bill for.

A tenant never sees another tenant's pool or params; the only shared
surfaces are the ones the paper identifies (host link, pod power), which the
multi-tenant runtime accounts for at the layer above.

The engine computes on ``model.device``; the KV pool lives there too unless a
plan or ``offload_kv`` moves part or all of it to (pinned) host memory.

On a mesh (a model built on a ``DeviceMesh``) every rank runs the same
engine over its shard of the parameters and of the pool: the requests, the
slots and the tokens are the same on every rank, the prefill's prompt and a
tick's tokens and per-row positions are laid out by the model's batch specs
(each rank keeping its slice of them), and the next tokens are the argmax of
the logits gathered whole (the head is vocab-parallel; a tick's logits are
small). An enc-dec or VLM tenant raises on a mesh, naming its ROADMAP item.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ENCDEC, VLM
from repro_torch.configs.shapes import ShapeSuite
from repro_torch.core.offload import OffloadPlan
from repro_torch.models.common import is_dtensor, lay_local, pspec
from repro_torch.models.transformer import deferred
from repro_torch.serving.kv_pool import KVPool

PyTree = Any


@dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,)
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    slot: Optional[int] = None
    truncated: bool = False      # evicted at max_seq before max_new_tokens
    # latency stamps, in engine ticks (the engine's unit of time):
    submit_tick: Optional[int] = None   # queued (or first seen at prefill)
    admit_tick: Optional[int] = None    # slot claimed, prefix written
    finish_tick: Optional[int] = None   # completed/evicted, end of that tick

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


def _pct(xs: List[int], q: float) -> float:
    return float(np.percentile(np.asarray(xs, dtype=float), q)) if xs else 0.0


@dataclass
class TenantStats:
    ticks: int = 0
    tokens_out: int = 0
    prefill_tokens: int = 0
    admitted: int = 0
    rejected: int = 0
    completed: int = 0
    truncated: int = 0
    # per-request latency samples (ticks): admission-queue wait and
    # end-to-end submit → completion — the autoscaler's SLO signal
    queue_wait_ticks: List[int] = field(default_factory=list)
    e2e_ticks: List[int] = field(default_factory=list)

    def latency_percentiles(self) -> Dict[str, float]:
        """p50/p99 of queue wait and end-to-end latency, in ticks."""
        return {
            "queue_wait_p50": _pct(self.queue_wait_ticks, 50),
            "queue_wait_p99": _pct(self.queue_wait_ticks, 99),
            "e2e_p50": _pct(self.e2e_ticks, 50),
            "e2e_p99": _pct(self.e2e_ticks, 99),
        }


def require_servable(model) -> None:
    """Raises, naming the ROADMAP item, for a tenant ``TenantEngine`` cannot
    serve on a mesh: an enc-dec (its cross K/V pool and the reference's
    decode of B positions a row need a design of their own) or a VLM (its
    inputs are embeddings, the engine feeds text tokens)."""
    if model.sharded and model.cfg.family == ENCDEC:
        raise deferred(model.cfg, "encdec_serving")
    if model.sharded and model.cfg.family == VLM:
        raise deferred(model.cfg, "vlm_serving")


class TenantEngine:
    def __init__(self, model, params: PyTree, *, slots: int, max_seq: int,
                 offload_kv: bool = False,
                 plan: Optional[OffloadPlan] = None,
                 max_queue: Optional[int] = None, name: str = "tenant"):
        require_servable(model)
        self.name = name
        self.model = model
        self.params = params
        self.slots = slots
        self.max_seq = max_seq
        self.device = model.device
        self.plan = plan
        self.pool = KVPool(model, slots, max_seq, plan=plan,
                           offload_all=offload_kv)
        self.queue: Deque[Request] = deque()
        self.max_queue = max_queue
        self.live: Dict[int, Request] = {}           # slot -> request
        self.outputs: Dict[int, List[int]] = {}      # rid -> generated
        self.stats = TenantStats()
        self.ticks = 0

    # -- compatibility properties (pre-refactor ServingEngine surface) -----
    @property
    def cache(self) -> PyTree:
        return self.pool.materialize()

    @property
    def positions(self) -> np.ndarray:
        return self.pool.positions

    # ------------------------------------------------------------------
    # admission control
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Queue a request; False = rejected (queue at its admission bound)."""
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.stats.rejected += 1
            return False
        if req.submit_tick is None:
            req.submit_tick = self.ticks
        self.queue.append(req)
        return True

    @property
    def idle(self) -> bool:
        return not self.queue and not self.live

    # ------------------------------------------------------------------
    # prefill path
    # ------------------------------------------------------------------
    def prefill(self, req: Request) -> bool:
        """Claim a slot and write the request's KV prefix into the pool."""
        if len(req.prompt) > self.max_seq - 1:
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"exceeds max_seq-1 ({self.max_seq - 1}) — queue path "
                f"rejects these; direct prefill callers must pre-check")
        slot = self.pool.alloc_slot()
        if slot is None:
            return False
        req.slot = slot
        tokens = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.device)[None, :]
        batch = self._lay({"tokens": tokens}, "prefill")
        _, _, pc = self.model.forward(self.params, batch, return_cache=True)
        plen = len(req.prompt)
        self.pool.paste(slot, pc, plen)
        self.live[slot] = req
        if req.submit_tick is None:
            req.submit_tick = self.ticks   # direct-admit callers skip submit()
        req.admit_tick = self.ticks
        self.stats.queue_wait_ticks.append(req.admit_tick - req.submit_tick)
        self.stats.admitted += 1
        self.stats.prefill_tokens += plen
        return True

    def admit(self, req: Request) -> bool:
        """Pre-refactor surface: direct prefill, bypassing the queue."""
        return self.prefill(req)

    def _admit_from_queue(self) -> None:
        while self.queue and self.pool.free_slots:
            req = self.queue.popleft()
            if len(req.prompt) > self.max_seq - 1:
                # prompt can never fit the pool: reject it, visibly — an
                # empty result with the truncated flag, not a crash
                req.truncated = True
                self.outputs[req.rid] = req.generated
                self.stats.rejected += 1
                continue
            self.prefill(req)

    def _lay(self, batch: Dict[str, torch.Tensor], kind: str):
        """``batch`` (every row, the same on every rank) as the model takes
        it: as it is on one device; on a mesh, ``DTensor``s laid out by the
        model's batch specs for a ``kind`` step of this batch, each rank
        keeping its slice (a prompt's tokens split by sequence where the
        activations are; per-row positions over the tokens' batch axes)."""
        if not self.model.sharded:
            return batch
        B, S = batch["tokens"].shape
        specs = self.model.batch_specs(ShapeSuite(kind, kind, S, B))
        spec = {"tokens": specs["tokens"][2]}
        spec["pos"] = pspec(spec["tokens"][0])
        return {k: lay_local(v, spec[k], self.model.env)
                for k, v in batch.items()}

    # ------------------------------------------------------------------
    # decode path
    # ------------------------------------------------------------------
    def tick(self) -> int:
        """Admit what fits, then one decode step for every live slot.
        Returns tokens emitted."""
        self._admit_from_queue()
        if not self.live:
            return 0
        # batch the newest token of each live slot; idle slots get token 0
        tokens = np.zeros((self.slots, 1), np.int64)
        for slot, req in self.live.items():
            last = (req.generated[-1] if req.generated else int(req.prompt[-1]))
            tokens[slot, 0] = last
        # per-row cache positions: ragged continuous batching
        batch = self._lay(
            {"tokens": torch.as_tensor(tokens, device=self.device),
             "pos": torch.as_tensor(self.pool.positions.astype(np.int64),
                                    device=self.device)}, "decode")
        logits, new_cache = self.model.decode(
            self.params, self.pool.materialize(), batch)
        self.pool.update(new_cache)
        if is_dtensor(logits):
            logits = logits.full_tensor()
        emitted = 0
        next_tokens = torch.argmax(logits, dim=-1).cpu().numpy()
        for slot, req in list(self.live.items()):
            req.generated.append(int(next_tokens[slot]))
            self.pool.positions[slot] += 1
            emitted += 1
            if req.done or self.pool.positions[slot] >= self.max_seq - 1:
                if not req.done:
                    # evicted at the pool boundary: a *truncated* generation,
                    # recorded like any other (the pre-refactor engine
                    # silently dropped these)
                    req.truncated = True
                    self.stats.truncated += 1
                self.stats.completed += 1
                req.finish_tick = self.ticks + 1   # done by this tick's end
                self.stats.e2e_ticks.append(req.finish_tick - req.submit_tick)
                self.outputs[req.rid] = req.generated
                del self.live[slot]
                self.pool.free_slot(slot)
        self.ticks += 1
        self.stats.ticks += 1
        self.stats.tokens_out += emitted
        return emitted

    # ------------------------------------------------------------------
    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        """Drain a closed batch of requests (single-tenant convenience).
        Every request appears in the result — including ones evicted at
        ``max_seq`` with a partial generation (``req.truncated`` set)."""
        for r in requests:
            self.queue.append(r)    # closed batch: bypass the admission bound
        while not self.idle:
            self.tick()
        return dict(self.outputs)
