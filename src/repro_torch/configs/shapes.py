"""The four assigned input-shape suites and per-(arch × shape) applicability.

``train_*`` shapes lower ``train_step``; ``prefill_*`` lowers the prefill
``serve_step``; ``decode_*`` / ``long_*`` lower the single-token decode
``serve_step`` with a KV/state cache of ``seq_len``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from repro_torch.configs.base import ENCDEC, HYBRID, SSM, ModelConfig

TRAIN = "train"
PREFILL = "prefill"
DECODE = "decode"


@dataclass(frozen=True)
class ShapeSuite:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == DECODE:
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSuite("train_4k", TRAIN, 4_096, 256)
PREFILL_32K = ShapeSuite("prefill_32k", PREFILL, 32_768, 32)
DECODE_32K = ShapeSuite("decode_32k", DECODE, 32_768, 128)
LONG_500K = ShapeSuite("long_500k", DECODE, 524_288, 1)

SHAPES: Tuple[ShapeSuite, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def get_shape(name: str) -> ShapeSuite:
    try:
        return SHAPES_BY_NAME[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; have {sorted(SHAPES_BY_NAME)}")


def applicable(config: ModelConfig, shape: ShapeSuite) -> Tuple[bool, Optional[str]]:
    """(runs?, reason-if-skipped) — mirrors DESIGN.md §Arch-applicability.

    ``long_500k`` needs sub-quadratic sequence mixing: run only for SSM /
    hybrid families, skip for pure full-attention archs (incl. the enc-dec
    backbone, whose decoder self-attention is full attention).
    """
    if shape.name == "long_500k" and not config.subquadratic:
        return False, "full-attention arch: 524k-token decode is quadratic; skipped per assignment"
    if shape.kind == DECODE and not config.has_decoder:
        return False, "encoder-only arch has no decode step"
    return True, None


def reduced_shape(shape: ShapeSuite) -> ShapeSuite:
    """Tiny same-kind shape for CPU smoke tests."""
    return ShapeSuite(shape.name + "-smoke", shape.kind,
                      seq_len=min(shape.seq_len, 128),
                      global_batch=min(shape.global_batch, 2))


def prefill_len_for(config: ModelConfig, shape: ShapeSuite) -> int:
    """Sequence length already in cache when lowering a decode step."""
    assert shape.kind == DECODE
    return shape.seq_len
