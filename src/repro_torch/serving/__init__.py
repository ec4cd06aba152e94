"""repro_torch.serving — the single-tenant serving stack of the port."""
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.tenant import Request, TenantEngine, TenantStats
from repro_torch.serving.engine import ServingEngine

__all__ = ["KVPool", "Request", "TenantEngine", "TenantStats", "ServingEngine"]
