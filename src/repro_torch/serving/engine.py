"""The single-model ``ServingEngine`` name.

``ServingEngine`` is exactly a ``TenantEngine`` without a slice or an offload
plan of its own — kept so single-model callers read the same as with the
reference:

* ``repro_torch.serving.kv_pool.KVPool``      — slot-paged cache + host placement
* ``repro_torch.serving.tenant.TenantEngine`` — continuous batching per tenant
"""
from __future__ import annotations

from repro_torch.serving.tenant import Request, TenantEngine

__all__ = ["Request", "ServingEngine"]


class ServingEngine(TenantEngine):
    def __init__(self, model, params, *, slots: int, max_seq: int,
                 offload_kv: bool = False):
        super().__init__(model, params, slots=slots, max_seq=max_seq,
                         offload_kv=offload_kv)
