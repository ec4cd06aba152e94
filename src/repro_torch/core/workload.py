"""Analytic workload estimates: footprint, FLOPs, traffic per step.

The reward sweep (paper §VI-B) must evaluate every (profile × offload plan)
combination cheaply, so it uses these closed-form estimates rather than a
compile per point. The pod-scale dry-run (launch/dryrun.py) provides the
measured-from-HLO anchors; ``benchmarks/roofline.py`` cross-checks the two
(EXPERIMENTS.md §Roofline reports both where available).

All byte counts are *global per step*; roofline terms divide by chip count.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.configs.base import MOE, ModelConfig
from repro_torch.configs.shapes import DECODE, TRAIN, ShapeSuite
from repro_torch.core.hw import ChipSpec, HostSpec, V5E, V5E_HOST
from repro_torch.core.offload import (GROUP_TRAFFIC, OffloadPlan, TensorInfo,
                                TwinOffloadPlan, TwinShard, plan_offload,
                                plan_twin)
from repro_torch.core.roofline import RooflineTerms, model_flops_for
from repro_torch.core.slices import SliceProfile

# Twin-offload shard constants (documented modeling assumptions):
# Adam update arithmetic per parameter (m/v decay, bias correction, step) and
# the fp32 host-DRAM accesses it makes (read m,v,g,p; write m,v,p).
ADAM_FLOPS_PER_PARAM = 12.0
ADAM_DRAM_BYTES_PER_PARAM = 7 * 4
# Decode attention over a cached element: one MAC against K and one against V.
KV_FLOPS_PER_ELEMENT = 4.0
# Fraction of decode tokens routed through *cold* (spilled) MoE experts —
# cold by definition, so well under the uniform 1/num_experts share.
MOE_COLD_TOKEN_FRACTION = 0.1


@dataclass(frozen=True)
class WorkloadEstimate:
    cfg: ModelConfig
    shape: ShapeSuite

    # ------------------------------------------------------------------
    # memory footprint inventory (drives capacity + offload decisions)
    # ------------------------------------------------------------------
    def inventory(self) -> List[TensorInfo]:
        cfg, shape = self.cfg, self.shape
        N = cfg.param_count()
        embed_params = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
        body_params = N - embed_params
        inv: List[TensorInfo] = []
        if shape.kind == TRAIN:
            # fp32 master + grads + adam moments; bf16 working copy is transient
            inv += [
                TensorInfo("params/body", body_params * 4, "param", divisible=True),
                TensorInfo("params/embed", embed_params * 4, "embed", divisible=True),
                TensorInfo("grads", N * 4, "param", offloadable=False),
                TensorInfo("opt/mu", N * 4, "opt_state", divisible=True),
                TensorInfo("opt/nu", N * 4, "opt_state", divisible=True),
                TensorInfo("activations", self._act_checkpoint_bytes(),
                           "activation", divisible=True),
            ]
        else:
            inv += [
                TensorInfo("params/body", body_params * 2, "param", divisible=True),
                TensorInfo("params/embed", embed_params * 2, "embed", divisible=True),
            ]
            kv = self._kv_bytes()
            if kv:
                inv.append(TensorInfo("kv_cache", kv, "kv_cache", divisible=True,
                                      traffic_multiplier=(
                                          2.0 if shape.kind != DECODE else 0.05)))
        return inv

    def _act_checkpoint_bytes(self) -> int:
        """Layer-boundary activations saved by the default remat policy."""
        cfg, shape = self.cfg, self.shape
        return (cfg.num_layers * shape.global_batch * shape.seq_len
                * cfg.d_model * 2)

    def _kv_bytes(self) -> int:
        cfg, shape = self.cfg, self.shape
        if cfg.family == "ssm":
            state = (cfg.num_layers * shape.global_batch * cfg.ssm_heads
                     * cfg.ssm_head_dim * cfg.ssm_state * 4)
            conv = (cfg.num_layers * shape.global_batch * (cfg.conv_width - 1)
                    * (cfg.d_inner + 2 * cfg.ssm_state) * 2)
            return state + conv
        if cfg.family == "hybrid":
            napps = max(1, cfg.num_layers // max(cfg.attn_every, 1))
            attn_kv = (napps * shape.global_batch * shape.seq_len
                       * 2 * cfg.num_kv_heads * cfg.head_dim * 2)
            state = (cfg.num_layers * shape.global_batch * cfg.ssm_heads
                     * cfg.ssm_head_dim * cfg.ssm_state * 4)
            return attn_kv + state
        layers = cfg.num_layers + (cfg.encoder_layers if cfg.family == "encdec" else 0)
        return (cfg.num_layers * shape.global_batch * shape.seq_len
                * 2 * cfg.num_kv_heads * cfg.head_dim * 2)

    def footprint_bytes(self) -> int:
        return sum(t.bytes for t in self.inventory())

    # ------------------------------------------------------------------
    # per-step global FLOPs / traffic
    # ------------------------------------------------------------------
    def flops(self) -> float:
        base = model_flops_for(self.cfg, self.shape)
        if self.shape.kind != DECODE and self.cfg.num_heads:
            # attention scores/values matmuls: 12·B·S²·H·hd per layer (fwd+bwd
            # for train ×3 of fwd), causal halves it
            cfg, shape = self.cfg, self.shape
            attn = (cfg.num_layers * shape.global_batch * shape.seq_len ** 2
                    * cfg.num_heads * cfg.head_dim * 2 * 2) / 2
            base += attn * (3.0 if self.shape.kind == TRAIN else 1.0)
        return base

    def hbm_bytes(self) -> float:
        """Global HBM traffic per step (rough, documented factors)."""
        cfg, shape = self.cfg, self.shape
        N = cfg.active_param_count()
        tokens = shape.tokens_per_step
        if shape.kind == TRAIN:
            # params bf16 read fwd+bwd, grads written+reduced, adam r/w fp32,
            # activations written+read once around each remat boundary
            return (cfg.param_count() * (2 * 2 + 4 + 16)
                    + self._act_checkpoint_bytes() * 3.0
                    + tokens * cfg.d_model * 2 * 8)
        if shape.kind == DECODE:
            return N * 2 + self._kv_bytes() * 1.0 + tokens * cfg.d_model * 2 * 4
        return (N * 2 + self._kv_bytes() * 2.0
                + tokens * cfg.d_model * 2 * 8)

    def collective_bytes_per_chip(self, n_chips: int) -> float:
        """Per-chip collective traffic/step under our sharding (DESIGN.md §5).

        Key scaling fact (the source of the paper's sub-linear classes): the
        FSDP all-gather *received bytes per chip* are the full bf16 layer
        weights regardless of chip count, so this term does NOT shrink as the
        slice grows — more chips → relatively more collective-bound."""
        cfg, shape = self.cfg, self.shape
        if n_chips <= 1:
            return 0.0
        N = cfg.param_count()
        frac = (n_chips - 1) / n_chips
        tokens_local = shape.tokens_per_step / n_chips
        if shape.kind == TRAIN:
            fsdp_ag = 2 * N * 2 * frac          # recv full bf16 params, fwd+bwd
            grad_rs = N * 4 * frac              # send fp32 grads
            tp_acts = tokens_local * cfg.d_model * 2 * 2 * cfg.num_layers
            return fsdp_ag + grad_rs + tp_acts
        # inference: weights resident; TP activation reductions only
        layers = cfg.num_layers + (cfg.encoder_layers if cfg.family == "encdec" else 0)
        return tokens_local * cfg.d_model * 2 * 2 * max(layers, 1)

    def collective_count(self) -> int:
        """Collectives on the critical path per step (latency floor)."""
        cfg, shape = self.cfg, self.shape
        per_layer = 4 if shape.kind == TRAIN else 2
        return max(1, per_layer * cfg.num_layers)

    # ------------------------------------------------------------------
    COLLECTIVE_LATENCY_S = 2.5e-6  # per-collective launch+sync latency

    def roofline_on(self, profile: SliceProfile, chip: ChipSpec = V5E,
                    plan: Optional[OffloadPlan] = None) -> RooflineTerms:
        n = profile.n_chips
        host_traffic = plan.host_traffic_per_step if plan else 0.0
        coll_pc = self.collective_bytes_per_chip(n)
        t_coll = coll_pc / chip.ici_bw
        if n > 1:  # latency floor: small workloads on big slices stall here
            t_coll += self.collective_count() * self.COLLECTIVE_LATENCY_S
        return RooflineTerms(
            t_compute=self.flops() / n / chip.peak_flops_bf16,
            t_memory=self.hbm_bytes() / n / chip.hbm_bw,
            t_collective=t_coll,
            t_host=host_traffic / profile.host_link_bw(chip),
            hlo_flops=self.flops() / n,
            hlo_bytes=self.hbm_bytes() / n,
            collective_bytes=coll_pc,
            host_bytes=host_traffic / n,
            model_flops=model_flops_for(self.cfg, self.shape),
            n_chips=n,
        )

    def plan_for(self, profile: SliceProfile, chip: ChipSpec = V5E) -> OffloadPlan:
        return plan_offload(self.inventory(), profile.hbm_bytes(chip),
                            host_budget=profile.host_dram_bytes(chip))

    # ------------------------------------------------------------------
    # twin-offload co-execution (compute shards eligible for the CPU side)
    # ------------------------------------------------------------------
    def twin_candidates(self, plan: OffloadPlan) -> List[TwinShard]:
        """Divisible compute-bearing shards whose *state already spilled* —
        running their consumer on the CPU replaces the state's link round
        trip with the (much smaller) operand/result exchange.

        Three shard kinds, per the twin-offload scheme:

        - ``opt_step`` (train): the Adam update over the spilled fraction of
          the moments. Removes the moments' round trip (``opt_state``
          traffic); adds fp32 grads down + updated master params up.
        - ``kv_tail`` (decode): attention over the spilled cold KV tail.
          Removes the tail gather; adds per-layer query/partial-output
          exchange.
        - ``moe_cold`` (MoE decode): cold-expert MLP where the spilled
          expert weights live. Removes the weight streaming; adds the
          routed tokens' activations both ways.

        ``cpu_fraction`` is a placeholder (1.0) here — ``plan_twin`` solves
        the actual split.
        """
        cfg, shape = self.cfg, self.shape
        inv = {t.name: t for t in self.inventory()}
        out: List[TwinShard] = []
        if shape.kind == TRAIN:
            spilled = sum(
                plan.spilled_fraction(n, inv[n].bytes) * inv[n].bytes
                for n in ("opt/mu", "opt/nu") if n in inv)
            if spilled > 0:
                # spilled moment bytes map to phi*N params (m+v = 8 bytes/param)
                n_params = spilled / 8.0
                out.append(TwinShard(
                    "opt_step", "opt_state", 1.0,
                    flops=ADAM_FLOPS_PER_PARAM * n_params,
                    cpu_bytes=ADAM_DRAM_BYTES_PER_PARAM * n_params,
                    link_bytes=8.0 * n_params,  # grads down + params up, fp32
                    link_bytes_saved=GROUP_TRAFFIC["opt_state"] * spilled))
        if shape.kind == DECODE and "kv_cache" in inv:
            t = inv["kv_cache"]
            frac = plan.spilled_fraction("kv_cache", t.bytes)
            if frac > 0:
                # bytes/step the decode step actually touches in the spilled
                # tail (the same sparse-access model behind the 0.05 link
                # multiplier) — host-side attention touches them from DRAM
                # instead of over the link
                gather = t.traffic_per_step * frac
                exchange = (shape.tokens_per_step * cfg.d_model * 2 * 2
                            * cfg.num_layers)
                out.append(TwinShard(
                    "kv_tail", "kv_cache", 1.0,
                    flops=KV_FLOPS_PER_ELEMENT * gather / 2.0,
                    cpu_bytes=gather,
                    link_bytes=float(exchange),
                    link_bytes_saved=gather))
        if shape.kind == DECODE and cfg.family == MOE:
            spilled = sum(
                plan.spilled_fraction(n, inv[n].bytes) * inv[n].bytes
                for n in ("params/body",) if n in inv)
            if spilled > 0:
                tokens = shape.tokens_per_step * MOE_COLD_TOKEN_FRACTION
                out.append(TwinShard(
                    "moe_cold", "param", 1.0,
                    flops=2.0 * (spilled / 2.0) * tokens,
                    cpu_bytes=spilled,
                    link_bytes=tokens * cfg.d_model * 2 * 2,
                    link_bytes_saved=GROUP_TRAFFIC["param"] * spilled))
        return out

    def twin_plan_for(self, profile: SliceProfile, chip: ChipSpec = V5E,
                      host: HostSpec = V5E_HOST, *,
                      max_cpu_fraction: float = 1.0
                      ) -> Optional[TwinOffloadPlan]:
        """Solved twin split for this workload on ``profile`` — ``None`` when
        the memory plan doesn't fit, nothing compute-bearing spilled, or
        the solver keeps every candidate at fraction zero (the plain path
        is already optimal, e.g. behind a coherence-scaled link)."""
        plan = self.plan_for(profile, chip)
        if not plan.fits:
            return None
        cands = self.twin_candidates(plan)
        if not cands:
            return None
        base = self.roofline_on(profile, chip, plan)
        gpu_floor = max(base.t_compute, base.t_memory, base.t_collective)
        twin = plan_twin(
            plan, cands, gpu_floor_s=gpu_floor,
            link_bw=profile.host_link_bw(chip), host=host,
            n_hosts=profile.n_hosts(chip),
            max_cpu_fraction=max_cpu_fraction)
        return twin if twin.shards else None

    def roofline_twin(self, profile: SliceProfile, twin: TwinOffloadPlan,
                      chip: ChipSpec = V5E) -> RooflineTerms:
        """Roofline terms for a twin rung: the GPU-side terms of the base
        plan with the host term re-priced at the split's residual link
        traffic (coherence-scaled) and the CPU service time added."""
        from dataclasses import replace as _replace
        base = self.roofline_on(profile, chip, twin.base)
        return _replace(base, t_host=twin.t_link, t_cpu=twin.t_cpu,
                        host_bytes=twin.link_traffic_per_step / profile.n_chips)
