"""Architecture registry: ``get_config(arch_id)`` + the shape suites.

The ten assigned architectures (public-literature configs) plus the paper's
own two LLM workloads (GPT-2 training via llm.c, Llama-3-8B inference via
llama.cpp — paper Table III).
"""
from __future__ import annotations

import importlib
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import shapes  # noqa: F401  (re-export)
from repro_torch.configs.shapes import SHAPES, ShapeSuite, applicable, get_shape

# arch-id -> module name
_ARCH_MODULES = {
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b_a6_6b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen3-32b": "qwen3_32b",
    "command-r-35b": "command_r_35b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "whisper-large-v3": "whisper_large_v3",
    "zamba2-1.2b": "zamba2_1_2b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "mamba2-130m": "mamba2_130m",
    # paper's own workloads
    "gpt2-124m": "gpt2_124m",
    "llama3-8b": "llama3_8b",
}

ASSIGNED_ARCHS: List[str] = list(_ARCH_MODULES)[:10]
PAPER_ARCHS: List[str] = list(_ARCH_MODULES)[10:]
ALL_ARCHS: List[str] = list(_ARCH_MODULES)

_cache: Dict[str, ModelConfig] = {}


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; have {ALL_ARCHS}")
    if arch not in _cache:
        mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
        _cache[arch] = mod.CONFIG
    return _cache[arch]


def tenant_config(arch: str, *, full_size: bool = False,
                  attn_impl: Optional[str] = None) -> ModelConfig:
    """The config a served tenant runs: the published widths and depth in
    bf16 weights, or the reduced same-family config; no remat."""
    cfg = get_config(arch)
    if full_size:
        cfg = cfg.with_(remat="none", param_dtype="bfloat16")
    else:
        cfg = cfg.reduced().with_(remat="none")
    if attn_impl:
        cfg = cfg.with_(attn_impl=attn_impl)
    return cfg


def all_cells(archs=None, include_skipped: bool = False):
    """Yield (config, shape, skip_reason) for the assigned 10×4 grid."""
    for arch in archs or ASSIGNED_ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, reason = applicable(cfg, shape)
            if ok or include_skipped:
                yield cfg, shape, (None if ok else reason)


__all__ = [
    "ModelConfig", "ShapeSuite", "SHAPES", "get_config", "get_shape",
    "tenant_config",
    "applicable", "all_cells", "ASSIGNED_ARCHS", "PAPER_ARCHS", "ALL_ARCHS",
]
