"""repro_torch.serving — the serving stack of the port: one tenant's engine
over its KV pool, and the multi-tenant SliceRuntime above them."""
from repro_torch.serving.kv_pool import KVPool
from repro_torch.serving.tenant import Request, TenantEngine, TenantStats
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.runtime import SliceRuntime, TenantSpec

__all__ = ["KVPool", "Request", "TenantEngine", "TenantStats", "ServingEngine",
           "SliceRuntime", "TenantSpec"]
