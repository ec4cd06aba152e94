"""SliceRuntime — multi-tenant serving on one statically partitioned pod.

The paper's system put together end to end on the real engine:

1. **Place** — each tenant asks for a slice profile; ``StaticPartitioner``
   packs the rectangles onto the modelled pod's grid and fails loudly when
   they don't fit (§IV/§V-A).
2. **Plan** — the tenant's *measured* inventory (its actual params and KV
   pool, via ``Model.serving_inventory``) goes through ``plan_offload``
   against the slice's HBM; an overhang spills to pinned host memory: whole
   parameter leaves by ``place_tree``, partial KV spills as a physically
   split cold tail in the tenant's ``KVPool`` (§VI-A). A product with a
   host-placed weight streams it over the host link through the
   ``stream_matmul`` kernel (``models.common.weight_matmul``).
3. **Serve** — every tenant runs a ``TenantEngine`` (continuous batching,
   admission control); the runtime drives them round-robin and reports
   per-tenant tokens/sec plus pod utilization.
4. **Account** — the shared surfaces partitioning does NOT isolate (pod
   power delivery, §V-B) are priced by ``core.power`` through the shared
   ``PerfModel``: the report's ``modeled`` block is the reference's power
   model of the modelled pod (``core/hw.py``), not a reading of the GPU.

The slices are logical: every tenant computes on the runtime's one
``device``. Parameters are placed by the plan when that device is CUDA; on
the CPU both tiers are the same memory and placement is skipped, as the
reference skips it without a mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.shapes import get_shape
from repro_torch.core.hw import PodSpec, V5E_POD
from repro_torch.core.offload import OffloadPlan, place_tree, plan_offload
from repro_torch.core.partitioner import SliceAllocation, StaticPartitioner
from repro_torch.core.perfmodel import InstanceLoad, PerfModel, get_model
from repro_torch.core.slices import SliceProfile, get_profile, smallest_fitting
from repro_torch.models.common import resolve_device, tree_bytes
from repro_torch.models.model_zoo import build_model
from repro_torch.serving.tenant import Request, TenantEngine


@dataclass(frozen=True)
class TenantSpec:
    """Everything the runtime needs to admit one tenant."""
    name: str
    cfg: ModelConfig
    profile: Union[str, SliceProfile, None] = None  # None -> smallest fitting
    slots: int = 4
    max_seq: int = 128
    max_queue: Optional[int] = None
    # Override the slice's HBM budget for the offload plan. Reduced-scale
    # demo models fit any real slice trivially; pinning the budget below the
    # tenant's footprint exercises the same plan->spill path a full-size
    # model hits on a real 16-chip slice.
    hbm_budget: Optional[int] = None
    # Spill granule for divisible tensors; default (None) keeps the
    # production 64 MiB granule — shrink it alongside hbm_budget in demos.
    spill_granule: Optional[int] = None
    shape: str = "decode_32k"   # ShapeSuite for the modeled power accounting
    seed: int = 0
    # Pin the slice rectangle's origin (must be profile-aligned and free);
    # None keeps the partitioner's first-fit origin.
    origin: Optional[tuple] = None


@dataclass
class Tenant:
    spec: TenantSpec
    alloc: SliceAllocation
    model: object
    params: object
    plan: OffloadPlan
    engine: TenantEngine
    inventory_bytes: int
    wall_s: float = 0.0
    submitted: int = 0

    @property
    def name(self) -> str:
        return self.spec.name


class SliceRuntime:
    def __init__(self, pod: PodSpec = V5E_POD, device="cuda",
                 partitioner: Optional[StaticPartitioner] = None,
                 perf: Optional[PerfModel] = None):
        self.pod = pod
        # execution device of every tenant (default CUDA; raises without a
        # card unless the caller asks for the CPU)
        self.device = resolve_device(device)
        # an externally owned partitioner lets a cluster-level scheduler
        # share one pod grid between its own modeled jobs and this
        # runtime's live tenants
        self.partitioner = (partitioner if partitioner is not None
                            else StaticPartitioner(pod))
        # shared performance engine: throttle/energy accounting goes through
        # the same memoized PerfModel the cluster scheduler scores with
        self.perf = perf if perf is not None else get_model(pod.chip)
        self.tenants: Dict[str, Tenant] = {}

    # ------------------------------------------------------------------
    # tenant lifecycle
    # ------------------------------------------------------------------
    def _resolve_profile(self, spec: TenantSpec, footprint: int
                         ) -> SliceProfile:
        if isinstance(spec.profile, SliceProfile):
            return spec.profile
        if isinstance(spec.profile, str):
            return get_profile(spec.profile)
        prof = smallest_fitting(footprint, 0.0, self.pod)
        if prof is None:
            raise RuntimeError(
                f"tenant {spec.name!r}: footprint {footprint} bytes exceeds "
                f"every slice profile")
        return prof

    def add_tenant(self, spec: TenantSpec) -> Tenant:
        """Place, plan, and spin up one tenant. Raises (loudly) when the pod
        has no room for the requested profile or the tenant cannot fit its
        slice even with everything offloadable spilled."""
        if spec.name in self.tenants:
            raise ValueError(f"duplicate tenant {spec.name!r}")
        model = build_model(spec.cfg, self.device)
        gen = torch.Generator(device=self.device).manual_seed(spec.seed)
        params, _ = model.init(gen)
        footprint = (tree_bytes(params)
                     + model.cache_bytes(spec.slots, spec.max_seq))

        profile = self._resolve_profile(spec, footprint)
        alloc = self.partitioner.allocate(profile, tag=spec.name,
                                          origin=spec.origin)
        try:
            tenant = self._plan_and_build(spec, profile, alloc, model,
                                          params, footprint)
        except Exception:
            self.partitioner.release(alloc.slice_id)
            raise
        self.tenants[spec.name] = tenant
        return tenant

    def _plan(self, spec: TenantSpec, profile: SliceProfile, model,
              params) -> OffloadPlan:
        """The tenant's offload plan on ``profile``, cut from its measured
        inventory (the KV pool as meta tensors: sizes only)."""
        chip = self.pod.chip
        inventory = model.serving_inventory(
            params, model.cache_shapes(spec.slots, spec.max_seq))
        hbm_budget = (spec.hbm_budget if spec.hbm_budget is not None
                      else profile.hbm_bytes(chip))
        plan = plan_offload(
            inventory, hbm_budget,
            host_budget=profile.host_dram_bytes(chip),
            **({"spill_granule": spec.spill_granule}
               if spec.spill_granule is not None else {}))
        if not plan.fits:
            raise RuntimeError(
                f"tenant {spec.name!r} does not fit {profile.name}: "
                f"{plan.resident_bytes} resident bytes > {hbm_budget} budget "
                f"even after spilling {plan.host_bytes} to host")
        return plan

    def _plan_and_build(self, spec, profile, alloc, model, params,
                        footprint) -> Tenant:
        plan = self._plan(spec, profile, model, params)
        if self.device.type == "cuda":
            params = place_tree({"params": params}, plan,
                                self.device)["params"]
        engine = TenantEngine(
            model, params, slots=spec.slots, max_seq=spec.max_seq,
            plan=plan, max_queue=spec.max_queue, name=spec.name)
        return Tenant(spec=spec, alloc=alloc, model=model, params=params,
                      plan=plan, engine=engine, inventory_bytes=footprint)

    def remove_tenant(self, name: str, *, repack: bool = False) -> None:
        tenant = self.tenants.pop(name)
        self.partitioner.release(tenant.alloc.slice_id)
        if repack:
            self.partitioner.repack()

    def resize_tenant(self, name: str,
                      profile: Union[str, SliceProfile]) -> Tenant:
        """Move a live tenant to a different slice profile, probe before
        commit:

        1. **probe** — re-plan the tenant's measured inventory against the
           new profile's HBM/host budgets; a plan that does not fit raises
           before anything moves.
        2. **commit** — ``StaticPartitioner.resize`` swaps the rectangle
           transactionally (the slice keeps its id; growing requires the
           extension chips to be free, and a conflict raises with the grid
           untouched).

        A pinned ``spec.hbm_budget`` (demo tenants) is kept as-is, like
        ``add_tenant`` does. As in the reference, the KV pool, the engine
        and the parameters' placement keep running across the resize —
        what changes is the rectangle, the offload plan, and the modeled
        power/throttle accounting."""
        tenant = self.tenants[name]
        profile = (get_profile(profile) if isinstance(profile, str)
                   else profile)
        if profile.name == tenant.alloc.profile.name:
            return tenant
        plan = self._plan(tenant.spec, profile, tenant.model, tenant.params)
        self.partitioner.resize(tenant.alloc.slice_id, profile)
        tenant.plan = plan
        return tenant

    # ------------------------------------------------------------------
    # serving
    # ------------------------------------------------------------------
    def submit(self, name: str, requests: Sequence[Request]) -> int:
        """Queue requests for one tenant; returns how many were admitted
        past the tenant's admission bound."""
        tenant = self.tenants[name]
        n = sum(tenant.engine.submit(r) for r in requests)
        tenant.submitted += n
        return n

    def step(self) -> Dict[str, int]:
        """One round-robin sweep: each tenant admits + decodes one tick.
        A tick ends by reading its tokens back to the host, which waits for
        the device, so the host clock around it times the tick's work."""
        out = {}
        for tenant in self.tenants.values():
            if tenant.engine.idle:
                continue
            t0 = time.perf_counter()
            out[tenant.name] = tenant.engine.tick()
            tenant.wall_s += time.perf_counter() - t0
        return out

    def run(self, max_ticks: Optional[int] = None) -> Dict[str, dict]:
        """Drive all tenants until every queue drains (or ``max_ticks``)."""
        ticks = 0
        while any(not t.engine.idle for t in self.tenants.values()):
            if max_ticks is not None and ticks >= max_ticks:
                break
            self.step()
            ticks += 1
        return self.report()

    # ------------------------------------------------------------------
    # accounting (paper Figs. 5-7 quantities, modelled for the pod)
    # ------------------------------------------------------------------
    def _instance_loads(self, steps: int = 100) -> List[InstanceLoad]:
        """Pod-scale modeled loads for the live tenant mix, scored by the
        shared ``PerfModel`` (full-size analytic numbers whatever configs
        the tenants execute)."""
        loads = []
        for tenant in self.tenants.values():
            sc = self.perf.score(tenant.spec.cfg,
                                 get_shape(tenant.spec.shape),
                                 tenant.alloc.profile)
            if sc is None:   # cannot fit per the full-scale model: account
                # it as a fully-utilized slice rather than dropping it
                loads.append(InstanceLoad(tenant.alloc.profile.n_chips,
                                          1.0, 1.0, steps))
            else:
                loads.append(sc.load(steps))
        return loads

    def report(self) -> Dict[str, dict]:
        per_tenant = {}
        for tenant in self.tenants.values():
            eng = tenant.engine
            per_tenant[tenant.name] = {
                "profile": tenant.alloc.profile.name,
                "rect": tenant.alloc.rect,
                "tokens_out": eng.stats.tokens_out,
                "prefill_tokens": eng.stats.prefill_tokens,
                "completed": eng.stats.completed,
                "truncated": eng.stats.truncated,
                "rejected": eng.stats.rejected,
                "ticks": eng.stats.ticks,
                "tok_per_s": (eng.stats.tokens_out / tenant.wall_s
                              if tenant.wall_s else 0.0),
                "plan_host_bytes": tenant.plan.host_bytes,
                "plan_offloaded": list(tenant.plan.offloaded),
                "plan_partial": [n for n, _ in tenant.plan.partial],
                "kv_device_bytes": eng.pool.device_bytes,
                "kv_host_bytes": eng.pool.host_bytes,
                "latency": eng.stats.latency_percentiles(),
            }
            if self.perf.twin is not None:
                # twin-offload pricing for this tenant's rectangle: the
                # rung the cluster scheduler would co-execute host-side,
                # or None when the plain score already wins
                tw = self.perf.score_twin(tenant.spec.cfg,
                                          get_shape(tenant.spec.shape),
                                          tenant.alloc.profile)
                sc = self.perf.score(tenant.spec.cfg,
                                     get_shape(tenant.spec.shape),
                                     tenant.alloc.profile)
                per_tenant[tenant.name]["twin"] = None if tw is None else {
                    "rung": tw.rung,
                    "cpu_fraction": tw.twin.cpu_fraction,
                    "step_time_s": tw.step_time,
                    "speedup": (sc.step_time / tw.step_time
                                if sc is not None else None),
                }
        result = {
            "tenants": per_tenant,
            "pod_utilization": self.partitioner.utilization(),
            "free_chips": self.partitioner.free_chips(),
        }
        if self.tenants:
            run = self.perf.corun(self._instance_loads(), self.pod)
            result["modeled"] = {   # synthetic power calibration (hw.py)
                "throttle": run.throttle,
                "throttled": run.throttled,
                "makespan_s": run.makespan_s,
                "energy_J": run.energy_J,
            }
        return result
