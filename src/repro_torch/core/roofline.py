"""Three-term roofline analysis (the reference's, for the modelled chips).

    compute term    = HLO_FLOPs / (chips × peak_FLOP/s)
    memory term     = HLO_bytes / (chips × HBM_bw)
    collective term = collective_bytes / (chips × link_bw)
    (+ host term when an offload plan adds host-link traffic)

Sources: ``compiled.cost_analysis()`` supplies HLO_FLOPs and HLO_bytes
(per-device, since the module is SPMD-partitioned). Collective bytes are NOT
in cost_analysis — we parse the partitioned HLO text and sum operand sizes of
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute.

Loop multiplicity: jax.lax.scan lowers to a while loop whose body appears
ONCE in the HLO text but executes trip-count times. Collectives found inside
a while-body computation are therefore multiplied by ``loop_trip_count``
(supplied by the caller — the model's layer count). Nested scans (attention
KV chunks inside a layer) contain no collectives by construction of our
sharding, so a single multiplier is exact for this codebase; the parser still
reports which computations it scaled so this assumption is auditable.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.hw import ChipSpec, V5E

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}


def _shape_bytes(shape_str: str) -> int:
    """bytes of 'bf16[8,128]' / 'f32[]' ; tuples handled by caller."""
    m = re.match(r"([a-z0-9]+)\[([0-9,]*)\]", shape_str)
    if not m:
        return 0
    dt, dims = m.groups()
    size = 1
    if dims:
        for d in dims.split(","):
            size *= int(d)
    return size * _DTYPE_BYTES.get(dt, 4)


def _result_bytes(line: str) -> int:
    """Sum bytes of the op's result shape(s) on an HLO text line."""
    lhs = line.split("=", 1)
    if len(lhs) != 2:
        return 0
    # result type is after '=' : e.g.  %x = bf16[2,4]{1,0} all-gather(...)
    rhs = lhs[1].strip()
    total = 0
    for m in re.finditer(r"([a-z0-9]+\[[0-9,]*\])", rhs.split("(")[0]):
        total += _shape_bytes(m.group(1))
    return total


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int] = field(default_factory=dict)
    count_by_op: Dict[str, int] = field(default_factory=dict)
    scaled_computations: List[str] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def parse_collectives(hlo_text: str, loop_trip_count: int = 1
                      ) -> CollectiveStats:
    """Sum collective result bytes in partitioned HLO; collectives inside
    while-loop bodies are scaled by ``loop_trip_count``."""
    stats = CollectiveStats()
    # split into computations:  name { ... }
    comp_re = re.compile(r"^(%?[\w\.\-]+)\s*(?:\([^)]*\))?\s*->.*\{\s*$")
    # find while bodies: body=%name
    while_bodies = set(re.findall(r"body=(%?[\w\.\-]+)", hlo_text))
    cur_comp = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = comp_re.match(stripped)
        if m and stripped.endswith("{"):
            cur_comp = m.group(1)
            continue
        for op in COLLECTIVE_OPS:
            # "all-reduce(" or "all-reduce-start("
            if re.search(rf"=\s*(?:[a-z0-9\[\],{{}}\s/*]+)?{op}(?:-start)?\(",
                         stripped):
                nbytes = _result_bytes(stripped)
                mult = 1
                if cur_comp is not None and any(
                        cur_comp.lstrip("%").startswith(b.lstrip("%").split(".")[0])
                        or b in (cur_comp,) for b in while_bodies):
                    mult = loop_trip_count
                    if cur_comp not in stats.scaled_computations:
                        stats.scaled_computations.append(cur_comp)
                stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0) + nbytes * mult
                stats.count_by_op[op] = stats.count_by_op.get(op, 0) + mult
                break
    return stats


@dataclass
class RooflineTerms:
    """All times in seconds; per-step, per-chip view of one compiled program."""
    t_compute: float
    t_memory: float
    t_collective: float
    t_host: float
    hlo_flops: float            # per chip
    hlo_bytes: float            # per chip
    collective_bytes: float     # per chip
    host_bytes: float           # per chip
    model_flops: float          # 6·N·D (or analogous) — global useful FLOPs
    n_chips: int
    collectives: Optional[CollectiveStats] = None
    hlo_cost: Optional[object] = None            # core.hlo_analysis.HloCost
    xla_cost_analysis: Optional[dict] = None     # raw (loop-unaware) numbers
    # CPU-side service time of a twin-offload split (core.offload.plan_twin);
    # 0.0 everywhere except twin rungs, so plain scores are unchanged.
    t_cpu: float = 0.0

    @property
    def step_time(self) -> float:
        """Perfect-overlap lower bound: the slowest wall dominates."""
        return max(self.t_compute, self.t_memory, self.t_collective,
                   self.t_host, self.t_cpu)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective, "host": self.t_host,
                 "cpu": self.t_cpu}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs — catches remat/padding/redundancy waste.

        HLO flops are per-chip; model flops global."""
        total_hlo = self.hlo_flops * self.n_chips
        return self.model_flops / total_hlo if total_hlo else 0.0

    @property
    def model_flops_utilization(self) -> float:
        """Roofline-model MFU: useful FLOPs / (chips × peak × step_time)."""
        denom = self.n_chips * V5E.peak_flops_bf16 * self.step_time
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "t_host_s": self.t_host,
            "t_cpu_s": self.t_cpu,
            "step_time_s": self.step_time, "dominant": self.dominant,
            "hlo_flops_per_chip": self.hlo_flops,
            "hlo_bytes_per_chip": self.hlo_bytes,
            "collective_bytes_per_chip": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_mfu": self.model_flops_utilization,
            "n_chips": self.n_chips,
        }


def analyze(cost_analysis: Dict[str, float], hlo_text: str, n_chips: int,
            model_flops: float, *, loop_trip_count: int = 1,
            host_bytes_per_step: float = 0.0, chip: ChipSpec = V5E
            ) -> RooflineTerms:
    """Roofline terms from a compiled XLA module — the reference reads them
    from XLA HLO text through its loop-aware HLO analyzer. The port compiles
    no XLA modules; its counterpart (terms from timed steps on the card,
    written as the same anchor records ``perfmodel.load_anchors`` reads)
    is ROADMAP queue A item 14."""
    raise NotImplementedError(
        "roofline.analyze reads compiled XLA HLO, which the port does not "
        "produce; measured anchors are ROADMAP queue A item 14")


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS = 6·N·D for training (fwd+bwd), 2·N·D for inference;
    MoE uses active params (assignment §Roofline)."""
    n = cfg.active_param_count()
    tokens = shape.tokens_per_step
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens
