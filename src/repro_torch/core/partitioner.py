"""StaticPartitioner — carve a pod's device grid into isolated sub-slices.

The TPU analogue of creating MIG GPU instances (paper §II-B3): each allocated
slice owns a disjoint rectangle of chips (disjoint ICI links → physical
isolation of compute, HBM and interconnect; only host links and pod power
delivery stay shared — exactly the residual interference surface the paper
identifies). Each slice names the device it runs on (``SliceAllocation.device``):
the port serves every slice of a modelled pod on one GPU, so the rectangles
are logical and the allocation arithmetic is the reference's, rectangle for
rectangle.

Also implements the *elastic repartitioning* used by the fault-tolerant
runner: on chip/host failure, the workload is re-admitted onto the largest
still-free profile and the offload planner re-plans for the smaller HBM pool.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.hw import PodSpec, V5E_POD
from repro_torch.core.slices import PROFILES, SliceProfile


@dataclass
class SliceAllocation:
    slice_id: int
    profile: SliceProfile
    origin: Tuple[int, int]          # (row, col) of the rectangle
    devices: Optional[np.ndarray]    # 2D array of torch devices (or None)
    tag: str = ""

    @property
    def rect(self) -> Tuple[int, int, int, int]:
        r, c = self.origin
        return (r, c, r + self.profile.rows, c + self.profile.cols)

    def device(self) -> torch.device:
        """The device this slice's tenant computes on: the first of its
        rectangle (one GPU holds every slice of the modelled pod)."""
        assert self.devices is not None, "logical allocation has no devices"
        return torch.device(self.devices.flat[0])


_PROFILES_DESC = tuple(sorted(PROFILES, key=lambda p: -p.n_chips))


class StaticPartitioner:
    """Packs rectangular slices into the pod grid (first-fit, row-major).

    Free-rectangle index: every aligned-origin query (``origins_for``,
    ``largest_free_profile``, ``free_chips``, the placer's
    ``best_origin_for``) is answered from per-profile free-block bitmaps
    plus 2D prefix sums, rebuilt lazily when the grid generation counter
    moves — O(profiles) tiny numpy ops per mutation instead of an O(grid)
    rescan per probe. Anything that writes ``_grid`` from outside the
    class must call :meth:`mark_dirty`.
    """

    def __init__(self, pod: PodSpec = V5E_POD,
                 devices: Optional[Sequence] = None):
        self.pod = pod
        # the slice ladder this partitioner carves from — the full table by
        # default; a partition mode with a granularity floor installs a
        # filtered ladder via set_profiles() (MI300 SPX offers only the
        # coarse end). Index structures are derived from it, so a ladder
        # change is a grid mutation for caching purposes.
        self.profiles: Tuple[SliceProfile, ...] = PROFILES
        self._profiles_desc: Tuple[SliceProfile, ...] = _PROFILES_DESC
        self._grid = np.full((pod.rows, pod.cols), -1, dtype=np.int64)  # slice_id or -1
        self._next_id = 0
        self._gen = 0          # bumped on every grid mutation
        self._idx_gen = -1     # generation the cached index was built at
        self._idx: Optional[dict] = None
        self.allocations: Dict[int, SliceAllocation] = {}
        if devices is not None:
            devs = np.asarray(devices, dtype=object)
            if devs.size != pod.n_chips:
                raise ValueError(
                    f"need {pod.n_chips} devices for a {pod.rows}x{pod.cols} pod, "
                    f"got {devs.size}")
            self._devices = devs.reshape(pod.rows, pod.cols)
        else:
            self._devices = None

    # ------------------------------------------------------------------
    @property
    def generation(self) -> int:
        """Monotone grid-mutation counter. Every allocate/release/repack/
        extend/resize/fail/rollback bump moves it, so equal generations
        mean a bit-identical *free mask* — the structural validity token
        the scheduler's ``ProbeCache`` keys on. (Self-restoring probe
        trials re-stamp their starting value via ``restore_generation``,
        so generations identify the free structure, not slice ids.)"""
        return self._gen

    def restore_generation(self, gen: int) -> None:
        """Re-stamp ``generation`` after a self-restoring trial (release +
        re-allocate at the same origin) whose net effect on the free mask
        is nil. Only slice ids advanced, and nothing keyed on the
        generation reads ids: the free-rectangle index is derived from the
        free mask alone. A copy the trial rebuilt mid-flight must be
        dropped *eagerly* — re-stamping makes mid-trial generation values
        reusable, so a later trial could otherwise match a stale
        ``_idx_gen`` against a different grid. An index built at ``gen``
        itself (before the trial) stays valid: the free mask is back.
        Never call this after a mutation that changes which chips are
        free — that would serve stale index/cache entries."""
        if self._idx_gen > gen:
            self._idx_gen = -1
            self._idx = None
        self._gen = gen

    def mark_dirty(self) -> None:
        """Invalidate the free-rectangle index after external grid surgery
        (transaction rollback writes ``_grid`` wholesale, ``fail_chips``
        kills cells, a mode switch swaps the ladder). The cached ``_idx``
        is dropped *eagerly*, not just generation-bumped: a later
        ``restore_generation`` may re-stamp an older generation value, and
        a lazily retained index built after this mutation could then match
        that re-stamped generation against a different grid."""
        self._gen += 1
        self._idx = None
        self._idx_gen = -1

    def set_profiles(self, profiles: Sequence[SliceProfile]) -> None:
        """Install the slice ladder of a new partition mode and re-derive
        every ladder-ordered structure (descending scan order, the lazy
        free-rectangle index). A no-op ladder still counts as a mutation —
        callers switch modes, and mode identity lives above us."""
        self.profiles = tuple(profiles)
        self._profiles_desc = tuple(
            sorted(self.profiles, key=lambda p: -p.n_chips))
        self.mark_dirty()

    def _index(self) -> dict:
        """The free-rectangle index for the current grid generation,
        filled lazily per component: the free-cell count, and per profile
        a free-block bitmap (a block = one aligned candidate rectangle),
        its count, a 2D prefix sum (so "free blocks inside a block span"
        is O(1)), and the materialized origin list. Every entry is built
        on first use after a mutation — a drain-gate free-chip query never
        pays for placement-grade structures."""
        if self._idx_gen != self._gen or self._idx is None:
            self._idx = {"free": None, "free_mask": None, "blocks": {},
                         "counts": {}, "prefix": {}, "origins": {},
                         "best": {}, "largest": -1, "frag": None}
            self._idx_gen = self._gen
        return self._idx

    def _free_mask(self, idx: dict) -> np.ndarray:
        mask = idx["free_mask"]
        if mask is None:
            mask = idx["free_mask"] = self._grid == -1
        return mask

    def _blocks(self, idx: dict, profile: SliceProfile) -> list:
        """Free-block bitmap for ``profile`` as nested Python lists (the
        per-origin lookups below are scalar; list indexing beats numpy)."""
        B = idx["blocks"].get(profile.name)
        if B is None:
            a, b = profile.rows, profile.cols
            n_br = self.pod.rows // a
            n_bc = self.pod.cols // b
            if n_br and n_bc:
                arr = self._free_mask(idx)[:n_br * a, :n_bc * b].reshape(
                    n_br, a, n_bc, b).all(axis=(1, 3))
                idx["counts"][profile.name] = int(arr.sum())
                B = arr.tolist()
            else:
                idx["counts"][profile.name] = 0
                B = [[False] * n_bc for _ in range(n_br)]
            idx["blocks"][profile.name] = B
        return B

    def _prefix(self, idx: dict, profile: SliceProfile) -> list:
        """2D prefix sums of the free-block bitmap, as nested lists:
        ``P[i][j]`` = free blocks in ``B[:i, :j]``."""
        P = idx["prefix"].get(profile.name)
        if P is None:
            B = self._blocks(idx, profile)
            n_br = len(B)
            n_bc = len(B[0]) if n_br else 0
            P = [[0] * (n_bc + 1)]
            for i in range(n_br):
                row = [0]
                above = P[i]
                acc = 0
                Bi = B[i]
                for j in range(n_bc):
                    acc += Bi[j]
                    row.append(above[j + 1] + acc)
                P.append(row)
            idx["prefix"][profile.name] = P
        return P

    def origins_for(self, profile: SliceProfile) -> List[Tuple[int, int]]:
        """Every free origin for ``profile`` on the alignment grid (origins
        at multiples of the slice side — keeps packing fragmentation-free
        for power-of-two profiles), in row-major order. The candidate set a
        fragmentation-aware placer scores instead of taking first-fit's
        first hit."""
        idx = self._index()
        cached = idx["origins"].get(profile.name)
        if cached is None:
            B = self._blocks(idx, profile)
            a, b = profile.rows, profile.cols
            cached = [(i * a, j * b)
                      for i, row in enumerate(B)
                      for j, freeb in enumerate(row) if freeb]
            idx["origins"][profile.name] = cached
        return list(cached)

    def _find_origin(self, profile: SliceProfile) -> Optional[Tuple[int, int]]:
        """First-fit: the first free aligned origin, if any."""
        origins = self.origins_for(profile)
        return origins[0] if origins else None

    def allocate(self, profile: SliceProfile, tag: str = "",
                 origin: Optional[Tuple[int, int]] = None) -> SliceAllocation:
        if origin is not None:
            r, c = origin
            if r % profile.rows or c % profile.cols:
                raise ValueError(
                    f"origin {origin} not aligned for {profile.name} "
                    f"(must be multiples of {profile.rows}x{profile.cols})")
            if (r + profile.rows > self.pod.rows
                    or c + profile.cols > self.pod.cols
                    or not (self._grid[r:r + profile.rows,
                                       c:c + profile.cols] == -1).all()):
                raise RuntimeError(
                    f"origin {origin} not free for profile {profile.name}")
        else:
            origin = self._find_origin(profile)
        if origin is None:
            raise RuntimeError(f"no room for profile {profile.name} "
                               f"(free chips: {self.free_chips()})")
        sid = self._next_id
        self._next_id += 1
        r, c = origin
        self._grid[r:r + profile.rows, c:c + profile.cols] = sid
        self._gen += 1
        devs = (self._devices[r:r + profile.rows, c:c + profile.cols]
                if self._devices is not None else None)
        alloc = SliceAllocation(sid, profile, origin, devs, tag)
        self.allocations[sid] = alloc
        return alloc

    def release(self, slice_id: int) -> None:
        alloc = self.allocations.pop(slice_id)
        r, c, r2, c2 = alloc.rect
        self._grid[r:r2, c:c2] = -1
        self._gen += 1

    # ------------------------------------------------------------------
    def free_chips(self) -> int:
        idx = self._index()
        if idx["free"] is None:
            idx["free"] = int(self._free_mask(idx).sum())
        return idx["free"]

    def used_chips(self) -> int:
        return self.pod.n_chips - self.free_chips()

    def utilization(self) -> float:
        return self.used_chips() / self.pod.n_chips

    def validate(self) -> None:
        """Invariants: disjoint rectangles exactly covering their grid marks."""
        seen = np.full_like(self._grid, -1)
        for sid, a in self.allocations.items():
            r, c, r2, c2 = a.rect
            region = self._grid[r:r2, c:c2]
            if not (region == sid).all():
                raise AssertionError(f"slice {sid} region corrupted")
            if not (seen[r:r2, c:c2] == -1).all():
                raise AssertionError(f"slice {sid} overlaps another")
            seen[r:r2, c:c2] = sid
        marked = {int(s) for s in np.unique(self._grid) if s >= 0}
        if marked != set(self.allocations):
            raise AssertionError("grid marks do not match allocation table")

    # ------------------------------------------------------------------
    def fail_chips(self, chips: List[Tuple[int, int]]) -> List[int]:
        """Mark chips dead; returns slice_ids of affected allocations (which
        are released — the fault runner re-admits them elsewhere)."""
        affected = set()
        for (r, c) in chips:
            sid = int(self._grid[r, c])
            if sid >= 0:
                affected.add(sid)
        for sid in affected:
            self.release(sid)
        for (r, c) in chips:
            self._grid[r, c] = -2  # dead
        # Route through mark_dirty(), not a bare generation bump: killing
        # cells permanently changes the free mask, so the lazy index must
        # be dropped eagerly (see mark_dirty) and the generation move must
        # invalidate every ProbeCache entry keyed on the old value.
        self.mark_dirty()
        return sorted(affected)

    def largest_free_profile(self) -> Optional[SliceProfile]:
        idx = self._index()
        cached = idx["largest"]
        if cached == -1:
            cached = None
            for p in self._profiles_desc:
                self._blocks(idx, p)
                if idx["counts"][p.name]:
                    cached = p
                    break
            idx["largest"] = cached
        return cached

    def largest_free_profile_if(self, profile: SliceProfile,
                                origin: Tuple[int, int]
                                ) -> Optional[SliceProfile]:
        """Largest profile still placeable *after* hypothetically placing
        ``profile`` at ``origin`` — the look-ahead a fragmentation-aware
        placer ranks candidate origins by (arXiv 2512.16099's stranding
        metric). Answered from the free-rectangle index without touching
        the grid: a candidate block survives the hypothetical placement
        iff it is free now and disjoint from the probed rectangle, so the
        survivor count is (free blocks) − (free blocks inside the probed
        rectangle's block span), one prefix-sum lookup per profile."""
        idx = self._index()
        r0, c0 = origin
        pa, pb = profile.rows, profile.cols
        if (r0 % pa == 0 and c0 % pb == 0
                and r0 + pa <= self.pod.rows and c0 + pb <= self.pod.cols):
            B = self._blocks(idx, profile)
            free_here = B[r0 // pa][c0 // pb]
        else:   # unaligned probe — not index-addressable, read the grid
            free_here = bool(
                (self._grid[r0:r0 + pa, c0:c0 + pb] == -1).all())
        if not free_here:
            raise RuntimeError(f"origin {origin} not free for {profile.name}")
        return self._largest_after(idx, profile, r0, c0)

    def _largest_after(self, idx: dict, profile: SliceProfile,
                       r0: int, c0: int) -> Optional[SliceProfile]:
        """Largest profile with a free block disjoint from the rectangle
        ``profile`` @ ``(r0, c0)`` — prefix-sum arithmetic, no grid
        writes: survivors = (free blocks) − (free blocks whose block span
        intersects the probed rectangle)."""
        r1 = r0 + profile.rows
        c1 = c0 + profile.cols
        for q in self._profiles_desc:
            self._blocks(idx, q)
            cnt = idx["counts"][q.name]
            if not cnt:
                continue
            qa, qb = q.rows, q.cols
            P = self._prefix(idx, q)
            n_br, n_bc = len(P) - 1, len(P[0]) - 1
            i0 = min(n_br, r0 // qa)
            i1 = min(n_br, -(-r1 // qa))
            j0 = min(n_bc, c0 // qb)
            j1 = min(n_bc, -(-c1 // qb))
            overlap = 0
            if i1 > i0 and j1 > j0:
                overlap = P[i1][j1] - P[i0][j1] - P[i1][j0] + P[i0][j0]
            if cnt - overlap > 0:
                return q
        return None

    def best_origin_for(self, profile: SliceProfile
                        ) -> Optional[Tuple[Tuple[int, int], int]]:
        """The fragmentation-aware placer's scored scan, answered from the
        index and memoized per grid generation: the first free origin (in
        row-major order) maximizing the chips of the largest profile still
        placeable afterwards. Returns ``((row, col), chips_after)`` or
        ``None`` when no aligned origin is free."""
        idx = self._index()
        key = profile.name
        if key in idx["best"]:
            return idx["best"][key]
        origins = self.origins_for(profile)
        if not origins:
            idx["best"][key] = None
            return None
        # Hoist the per-q structures out of the origin loop (each origin's
        # survivor test is then pure arithmetic on them), and stop at the
        # first origin preserving the largest currently-free profile —
        # survivors are a subset of the free blocks, so nothing later can
        # beat it, and the strictly-greater scan keeps the first max.
        pa, pb = profile.rows, profile.cols
        qinfo = []
        for q in self._profiles_desc:
            self._blocks(idx, q)
            cnt = idx["counts"][q.name]
            if cnt:
                qinfo.append((q.n_chips, q.rows, q.cols, cnt,
                              self._prefix(idx, q)))
        ceiling = qinfo[0][0] if qinfo else 0
        best = None
        for origin in origins:
            r0, c0 = origin
            r1 = r0 + pa
            c1 = c0 + pb
            chips = 0
            for n_chips, qa, qb, cnt, P in qinfo:
                n_br = len(P) - 1
                n_bc = len(P[0]) - 1
                i0 = min(n_br, r0 // qa)
                i1 = min(n_br, -(-r1 // qa))
                j0 = min(n_bc, c0 // qb)
                j1 = min(n_bc, -(-c1 // qb))
                overlap = 0
                if i1 > i0 and j1 > j0:
                    overlap = P[i1][j1] - P[i0][j1] - P[i1][j0] + P[i0][j0]
                if cnt - overlap > 0:
                    chips = n_chips
                    break
            if best is None or chips > best[1]:
                best = (origin, chips)
                if chips == ceiling:
                    break
        idx["best"][key] = best
        return best

    def fragmentation_ratio(self) -> float:
        """How far the largest placeable profile falls short of what the
        free chip *count* promises: ``1 - placeable / promised`` where
        ``promised`` is the biggest profile with ``n_chips <= free``. 0 on
        an empty or compactly packed grid (where the count keeps its
        promise), 0.5 in the showcase stranding state (128 chips free, but
        only an 8×8 placeable)."""
        idx = self._index()
        cached = idx["frag"]
        if cached is not None:
            return cached
        free = self.free_chips()
        promised = max((p.n_chips for p in self.profiles
                        if p.n_chips <= free), default=0)
        if promised == 0:
            ratio = 0.0
        else:
            largest = self.largest_free_profile()
            placeable = largest.n_chips if largest else 0
            ratio = max(0.0, 1.0 - placeable / promised)
        idx["frag"] = ratio
        return ratio

    def repack(self) -> Dict[int, Tuple[int, int]]:
        """Defragment: re-place every live allocation largest-first from a
        clean grid (dead chips stay dead). Long-lived multi-tenant runtimes
        interleave allocate/release, and first-fit on the alignment grid can
        strand free rectangles that no longer admit a large profile even
        though enough chips are free — the fragmentation problem of
        arXiv 2512.16099. Returns {slice_id: new_origin} for moved slices.

        Note: this moves *logical* rectangles; a real runtime would migrate
        the tenant's state between the old and new device sets.
        """
        old_grid = self._grid.copy()
        dead = self._grid == -2
        self._grid = np.full_like(self._grid, -1)
        self._grid[dead] = -2
        self._gen += 1
        placed: Dict[int, Tuple[int, int]] = {}
        for sid, alloc in sorted(self.allocations.items(),
                                 key=lambda kv: -kv[1].profile.n_chips):
            origin = self._find_origin(alloc.profile)
            if origin is None:
                self._grid = old_grid          # roll back, nothing was moved
                self._gen += 1
                raise RuntimeError(
                    f"repack failed: no room for live slice {sid} "
                    f"({alloc.profile.name}) — dead chips block every "
                    f"aligned origin")
            r, c = origin
            self._grid[r:r + alloc.profile.rows, c:c + alloc.profile.cols] = sid
            self._gen += 1
            placed[sid] = origin
        moved: Dict[int, Tuple[int, int]] = {}
        for sid, origin in placed.items():
            alloc = self.allocations[sid]
            if origin != alloc.origin:
                moved[sid] = origin
            alloc.origin = origin
            r, c = origin
            alloc.devices = (
                self._devices[r:r + alloc.profile.rows,
                              c:c + alloc.profile.cols]
                if self._devices is not None else None)
        self.validate()
        return moved

    def extend(self, slice_id: int, profile: SliceProfile) -> SliceAllocation:
        """Grow a live slice in place to a strictly larger ``profile`` —
        the rectangle-extension primitive behind the cluster scheduler's
        elastic-grow path (the symmetric move to its shrink).

        The slice keeps its ``slice_id``; its rectangle is extended to the
        aligned origin of ``profile`` that contains the current rectangle
        (power-of-two sides guarantee such an origin exists for any aligned
        slice). Every newly covered chip must currently be free — live
        neighbours are never displaced and dead chips are never absorbed.

        Transactional like ``repack()``: on any failure a ``RuntimeError``
        (or ``ValueError`` for a non-growing profile) is raised and the
        grid, the allocation table, and the allocation itself are exactly
        as before the call. Returns the updated allocation.
        """
        alloc = self.allocations[slice_id]
        old = alloc.profile
        if profile.rows < old.rows or profile.cols < old.cols \
                or profile.n_chips <= old.n_chips:
            raise ValueError(
                f"extend() only grows: {old.name} -> {profile.name} is not "
                f"a strict rectangle extension")
        r0, c0 = alloc.origin
        nr = (r0 // profile.rows) * profile.rows
        nc = (c0 // profile.cols) * profile.cols
        if nr + profile.rows > self.pod.rows or nc + profile.cols > self.pod.cols:
            raise RuntimeError(
                f"extend failed: {profile.name} at {(nr, nc)} exceeds the pod")
        region = self._grid[nr:nr + profile.rows, nc:nc + profile.cols]
        # every cell must be ours or free — no live neighbour, no dead chip
        if not ((region == slice_id) | (region == -1)).all():
            raise RuntimeError(
                f"extend failed: chips under {profile.name} at {(nr, nc)} "
                f"are not free (slice {slice_id} stays {old.name})")
        self._grid[nr:nr + profile.rows, nc:nc + profile.cols] = slice_id
        self._gen += 1
        alloc.profile = profile
        alloc.origin = (nr, nc)
        alloc.devices = (
            self._devices[nr:nr + profile.rows, nc:nc + profile.cols]
            if self._devices is not None else None)
        self.validate()
        return alloc

    def resize(self, slice_id: int, profile: SliceProfile) -> SliceAllocation:
        """Move a live slice to ``profile`` in place, keeping its
        ``slice_id`` — the one transaction primitive behind every elastic
        rectangle change (cluster ``Shrink``/``Grow`` actions, the serving
        runtime's ``resize_tenant``).

        Growing delegates to ``extend()`` (every newly covered chip must be
        free). Shrinking keeps the current origin: power-of-two profile
        sides make an origin aligned for a larger profile aligned for every
        smaller one, so the smaller rectangle always fits inside the old
        footprint and the trimmed chips free. Transactional: any failure
        raises and leaves the grid, the allocation table, and the
        allocation exactly as before the call.
        """
        alloc = self.allocations[slice_id]
        old = alloc.profile
        if profile is old or profile.name == old.name:
            return alloc
        if profile.rows >= old.rows and profile.cols >= old.cols:
            return self.extend(slice_id, profile)
        if profile.rows > old.rows or profile.cols > old.cols:
            raise ValueError(
                f"resize() needs comparable rectangles: {old.name} -> "
                f"{profile.name} neither grows nor shrinks both sides")
        r, c, r2, c2 = alloc.rect
        self._grid[r:r2, c:c2] = -1
        self._grid[r:r + profile.rows, c:c + profile.cols] = slice_id
        self._gen += 1
        alloc.profile = profile
        alloc.devices = (
            self._devices[r:r + profile.rows, c:c + profile.cols]
            if self._devices is not None else None)
        self.validate()
        return alloc

    def pack(self, demands: List[SliceProfile]) -> List[SliceAllocation]:
        """Allocate a list of profiles (largest first) — multi-tenant setup."""
        out = []
        for p in sorted(demands, key=lambda p: -p.n_chips):
            out.append(self.allocate(p))
        return out
