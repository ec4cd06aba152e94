"""Seeded request-arrival generators for serving tenants — the
"millions of users" input side of the autoscale control loop.

A ``LoadCurve`` maps virtual time to an instantaneous request rate
(requests/second). Two concrete shapes cover the classic serving
regimes:

* ``DiurnalCurve`` — a raised-cosine day/night swing with a per-tenant
  phase offset, the slow predictable tide every fleet sees.
* ``BurstyCurve`` — a seeded Poisson process of spike onsets, each
  decaying exponentially: flash crowds layered over a quiet floor.

Curves compose (``a + b``, ``0.5 * a``) so a tenant can be "diurnal
plus flash crowds" without a new class. One curve drives **both**
consumption paths from the same trace:

* the *analytic* path — ``arrival_counts`` buckets a seeded Poisson
  draw per control interval, which ``AutoscaleController`` feeds into
  its queue model against ``PodSimulator``-scheduled records;
* the *live* path — ``arrival_times`` draws individual arrival
  instants (Lewis thinning) you can replay into a ``TenantEngine``.

``serving_workload`` builds the matching long-lived serving ``Job``s:
pinned wall-clock duration (a tenant lives all day — the autoscaler
varies its *chips*, never its lifetime) plus one phase-staggered curve
per tenant. Rates are calibrated in units of the modeled service rate
of a reference slice profile (``service_rate``), so "peak = 2.2"
means *2.2× what the smallest slice can serve* regardless of arch.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.cluster.trace import (KIND_PRIORITY, KIND_SHAPE, SERVING, Job)

__all__ = [
    "LoadCurve", "ConstantCurve", "DiurnalCurve", "BurstyCurve",
    "CURVE_NAMES", "arrival_counts", "arrival_times", "service_rate",
    "serving_workload",
]

CURVE_NAMES = ("diurnal", "bursty")


class LoadCurve:
    """Instantaneous request rate over virtual time; composable."""

    def rate(self, t: float) -> float:
        raise NotImplementedError

    def __add__(self, other: "LoadCurve") -> "LoadCurve":
        return _SumCurve(self, other)

    def __mul__(self, k: float) -> "LoadCurve":
        return _ScaledCurve(self, float(k))

    __rmul__ = __mul__


@dataclass(frozen=True)
class ConstantCurve(LoadCurve):
    rps: float

    def rate(self, t: float) -> float:
        return self.rps


@dataclass(frozen=True)
class _SumCurve(LoadCurve):
    a: LoadCurve
    b: LoadCurve

    def rate(self, t: float) -> float:
        return self.a.rate(t) + self.b.rate(t)


@dataclass(frozen=True)
class _ScaledCurve(LoadCurve):
    inner: LoadCurve
    k: float

    def rate(self, t: float) -> float:
        return self.k * self.inner.rate(t)


@dataclass(frozen=True)
class DiurnalCurve(LoadCurve):
    """Raised-cosine day/night swing: trough ``base_rps`` at
    ``t = phase_s`` (mod period), peak ``peak_rps`` half a period later."""
    base_rps: float
    peak_rps: float
    period_s: float = 86400.0
    phase_s: float = 0.0

    def rate(self, t: float) -> float:
        theta = 2.0 * math.pi * (t - self.phase_s) / self.period_s
        return (self.base_rps
                + (self.peak_rps - self.base_rps) * 0.5 * (1.0 - math.cos(theta)))


class BurstyCurve(LoadCurve):
    """Flash crowds over a quiet floor: burst onsets are a seeded Poisson
    process (mean gap ``mean_gap_s``); each burst adds ``burst_rps`` that
    decays as ``exp(-(t - onset) / decay_s)``. Onsets are drawn once at
    construction, so ``rate`` is a pure deterministic function of ``t``."""

    def __init__(self, base_rps: float, burst_rps: float, *,
                 mean_gap_s: float, decay_s: float, seed=0,
                 horizon_s: float = 86400.0):
        self.base_rps = base_rps
        self.burst_rps = burst_rps
        self.decay_s = decay_s
        self.horizon_s = horizon_s
        rng = np.random.default_rng(seed)
        onsets: List[float] = []
        t = float(rng.exponential(mean_gap_s))
        while t < horizon_s:
            onsets.append(t)
            t += float(rng.exponential(mean_gap_s))
        self.onsets = np.asarray(onsets, dtype=float)

    def rate(self, t: float) -> float:
        active = self.onsets[self.onsets <= t]
        if active.size == 0:
            return self.base_rps
        # bursts older than ~9 decay constants contribute < 1.3e-4 of
        # their peak; keeping them costs nothing and stays exact
        return self.base_rps + self.burst_rps * float(
            np.exp(-(t - active) / self.decay_s).sum())


def get_curve(name: str, **kw) -> LoadCurve:
    """CLI registry: construct a named curve shape."""
    if name == "diurnal":
        return DiurnalCurve(**kw)
    if name == "bursty":
        return BurstyCurve(**kw)
    raise ValueError(f"unknown load curve {name!r}; valid: {CURVE_NAMES}")


# ---------------------------------------------------------------------------
# sampling: one curve, two consumption paths
# ---------------------------------------------------------------------------
def arrival_counts(curve: LoadCurve, interval_s: float, n_intervals: int,
                   seed=0) -> np.ndarray:
    """Seeded Poisson request counts per control interval (the analytic
    path). Interval ``k`` covers ``(k·dt, (k+1)·dt]`` with mean
    ``rate(midpoint) · dt`` — the midpoint rule is exact for the linear
    part of any smooth curve over one interval."""
    rng = np.random.default_rng(seed)
    lam = np.asarray([curve.rate((k + 0.5) * interval_s) * interval_s
                      for k in range(n_intervals)], dtype=float)
    return rng.poisson(np.maximum(lam, 0.0))


def arrival_times(curve: LoadCurve, horizon_s: float, seed=0,
                  max_rate: float = None) -> np.ndarray:
    """Individual seeded arrival instants via Lewis thinning (the live
    path — replay these into a ``TenantEngine``). ``max_rate`` bounds the
    proposal process; by default it is scanned from the curve."""
    if max_rate is None:
        grid = np.linspace(0.0, horizon_s, 512)
        max_rate = max(curve.rate(float(g)) for g in grid) * 1.1
    if max_rate <= 0.0:
        return np.empty(0, dtype=float)
    rng = np.random.default_rng(seed)
    out: List[float] = []
    t = 0.0
    while True:
        t += float(rng.exponential(1.0 / max_rate))
        if t >= horizon_s:
            break
        if rng.uniform() * max_rate <= curve.rate(t):
            out.append(t)
    return np.asarray(out, dtype=float)


# ---------------------------------------------------------------------------
# the matching cluster workload
# ---------------------------------------------------------------------------
def service_rate(arch: str, profile: str, *, req_per_step: float = 1.0,
                 shape: str = KIND_SHAPE[SERVING]) -> float:
    """Modeled requests/second a slice ``profile`` sustains for ``arch``:
    ``req_per_step`` requests complete per decode step of the shared
    ``PerfModel``'s step time. The calibration unit for load curves."""
    from repro_torch.configs import get_config, get_shape
    from repro_torch.core.perfmodel import get_model
    from repro_torch.core.slices import get_profile
    sc = get_model().score(get_config(arch), get_shape(shape),
                           get_profile(profile))
    return req_per_step / sc.step_time


def serving_workload(n_tenants: int = 2, curve: str = "diurnal", *,
                     horizon_s: float = 86400.0, seed: int = 0,
                     arch: str = "gpt2-124m",
                     start_profile: str = "1s.16c",
                     calibration_profile: str = "1s.16c",
                     base_frac: float = 0.2, peak_frac: float = 2.2,
                     period_s: float = None, phase_frac: float = 0.125,
                     slo_factor: float = 8.0,
                     req_per_step: float = 1.0,
                     ) -> Tuple[List[Job], Dict[int, LoadCurve]]:
    """Long-lived serving tenants plus their per-tenant load curves.

    Each tenant is one serving ``Job`` with a pinned wall-clock lifetime
    of ``horizon_s`` (the autoscaler changes its chips, never its
    lifetime) starting at ``start_profile``. Rates are fractions of the
    modeled service rate of ``calibration_profile`` — deliberately
    *independent* of ``start_profile``, so a fixed-provisioning run (big
    starting slice) and an autoscaled run (small starting slice) face
    the **same** traffic.

    Diurnal tenants are phase-staggered by ``phase_frac`` of the period;
    bursty tenants draw independent seeded burst onsets.
    """
    mu0 = service_rate(arch, calibration_profile, req_per_step=req_per_step)
    period = period_s if period_s is not None else horizon_s
    jobs: List[Job] = []
    curves: Dict[int, LoadCurve] = {}
    for i in range(n_tenants):
        if curve == "diurnal":
            c: LoadCurve = DiurnalCurve(base_frac * mu0, peak_frac * mu0,
                                        period_s=period,
                                        phase_s=i * phase_frac * period)
        elif curve == "bursty":
            c = BurstyCurve(base_frac * mu0, 1.2 * mu0,
                            mean_gap_s=period / 6.0, decay_s=period / 24.0,
                            seed=(seed, i), horizon_s=horizon_s)
        else:
            raise ValueError(
                f"unknown load curve {curve!r}; valid: {CURVE_NAMES}")
        jobs.append(Job(job_id=i, kind=SERVING, arch=arch,
                        shape=KIND_SHAPE[SERVING], arrival_s=0.0, steps=1,
                        slo_factor=slo_factor, profile=start_profile,
                        duration_s=horizon_s,
                        priority=KIND_PRIORITY[SERVING]))
        curves[i] = c
    return jobs, curves
