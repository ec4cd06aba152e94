"""Measured dry run: run, count and time one step of every (arch x shape) on
one card, and write the roofline records ``core.perfmodel.load_anchors``
reads.

The counterpart of the reference's ``launch/dryrun.py``, which lowers and
compiles each cell on 256- and 512-chip meshes and reads the compiled HLO.
The port has no compiler, so it **runs** one step of the cell instead, on
one card (``--mesh single``) or, for the reference's meshes, as one
device's shard of it (``--mesh pod``: 16 x 16, the reference's ``single``;
``--mesh multi``: 2 x 16 x 16; ``--mesh both``: the two). On one card:

* The global batch runs as ``k`` identical parts: gradient accumulation for
  ``train_*`` (``TrainStepConfig(microbatches)``), row splits for prefill and
  decode. One part is counted (``core.step_analysis.count_step``) and timed,
  and for ``train_*`` AdamW's update once; the record holds ``k x part +
  update``. ``k`` is the smallest power of two that divides the global batch
  and whose part fits ``PART_SHARE`` of the free device memory by
  ``part_bytes_per_sequence``; ``--set microbatches=N`` forces it.
* Training cells take the kernels' training route (``attn_impl="xla_cv"``:
  flash forward with lse and both backward kernels), prefill and decode cells
  the serving one (``"pallas"``), unless ``--set attn_impl=...`` says
  otherwise. Serving cells hold bf16 parameters, training cells fp32 ones
  with fp32 gradients and AdamW moments, as the port's serve and train paths.
* A decode cell allocates its ``seq_len`` cache and does not prefill it; its
  token is decoded at position ``seq_len - 1``, so the step reads the whole
  cache.
* A cell whose resident state (the parameters; for ``train_*`` also their
  gradients and the fp32 moments; one sequence's cache) exceeds the device
  even at one sequence is written as ``skipped`` with the bytes; the
  reference's ``applicable`` skips are kept; any other failure, running out
  of memory included, is an ``error`` record. Nothing is offloaded to make a
  cell fit (the reference's dry run does not).

Records go to ``<out>/single/<arch>__<shape>[__tag].json`` with the
reference's keys: ``roofline.hlo_flops_per_chip`` / ``hlo_bytes_per_chip``
hold the counted step (``n_chips`` 1), and ``roofline`` is
``core.roofline.analyze`` of that count on the reference's *modelled* chip
(a model, not the card's figures). The ``measured`` block holds the card's:
the part's ms (median, min, max of ``ITERS`` calls after ``WARMUP``, CUDA
events), ``k``, the update's ms, the step's ms, tokens/s, peak device bytes,
MFU against the H100's dense bf16 peak (a datasheet figure) and the card's
name and power limit as ``nvidia-smi`` gives them. A training record also
holds the part's ``loss``; ``loss_note`` marks it NaN by design where the
sequence runs past a learned position table (gpt2-124m at ``train_4k``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt2-124m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--include-paper-archs]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt2-124m \\
        --shape train_4k --reduced --device cpu --out /tmp/dryrun

On a mesh (``measure_mesh_cell``) the cell runs as one rank (``--rank``,
default 0) of a fake process group of 256 or 512 ranks
(``launch.mesh.fake_world``): the model is built on the mesh and holds that
rank's shards only, the training step splits the local batch by the
reference's ``_auto_microbatches`` and counts one part, and each collective
is counted by the bytes a device's would move but not run, so the loss is
not checked. Records go to ``<out>/pod/`` and ``<out>/multi/`` with
``mesh`` "16x16" / "2x16x16", ``n_devices`` and ``roofline.n_chips`` the
mesh's size, ``rank`` and its mesh ``coords``, per-device FLOPs, bytes and
collective bytes, and a ``note`` saying the collectives were counted, not
run. The ranks of a mesh differ where the sequence is split over the model
axis: a sequence-parallel rank attends keys up to its own tokens, so rank 0
(model 0) is the cheapest and model rank 15 (``--rank 15``) the heaviest.
An MoE record holds the experts its rank runs (``experts_sharded``,
``experts_local``), an SSM or hybrid record its SSM heads
(``ssm_sharded``, ``ssm_heads_local``). A cell whose policy needs a part not
yet ported on a mesh (an SSM scan across a sequence split) is an ``error``
record naming its ROADMAP item.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gpt2-124m \
        --shape train_4k --mesh multi --reduced --device cpu --out /tmp/dryrun
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-7b \
        --shape train_4k --mesh pod --rank 15 --reduced --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from typing import Callable, Dict, Optional

import torch

from repro_torch.configs import ALL_ARCHS, ASSIGNED_ARCHS, get_config, get_shape
from repro_torch.configs.base import HYBRID, MOE, SSM
from repro_torch.configs.shapes import (DECODE, PREFILL, SHAPES, TRAIN,
                                        ShapeSuite, applicable, reduced_shape)
from repro_torch.core.hw import GiB
from repro_torch.core.roofline import analyze, model_flops_for
from repro_torch.core.step_analysis import count_step
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import stream_matmul as sm
from repro_torch.launch.mesh import (MULTI_POD_SHAPE, POD_SHAPE, fake_world,
                                     make_production_mesh)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import local, resolve_device, tree_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.optim import adamw, compression
from repro_torch.train.train_step import _accumulate_grads

# ``build/`` is git-ignored; the reference's committed anchors live under
# benchmarks/artifacts/dryrun/ and are never written by the port
ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")
WARMUP, ITERS = 1, 3
# share of the free device memory a part may take by the estimate
PART_SHARE = 0.6
# NVIDIA H100 SXM5 datasheet: dense BF16 tensor-core peak
H100_BF16_PEAK_FLOPS = 989e12

# the production meshes by the port's names: "pod" is the reference's
# "single" (16 x 16), "multi" the same (2 x 16 x 16); the port's "single" is
# one card
MESHES = {"pod": POD_SHAPE, "multi": MULTI_POD_SHAPE}
MESH_KINDS = {"single": ["single"], "pod": ["pod"], "multi": ["multi"],
              "both": ["pod", "multi"]}

WRAPPERS = {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
            "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "stream_matmul": sm.stream_matmul,
            "ssd_scan": ssd.ssd_scan,
            "grouped_matmul": gmm.grouped_matmul}


def cell_config(arch: str, shape: ShapeSuite, *, reduced: bool = False,
                remat: Optional[str] = None, overrides: Optional[Dict] = None):
    """The cell's config: reduced or full, the kernel route of its kind
    (training ``xla_cv``, serving ``pallas``), bf16 parameters for serving,
    then ``remat`` and the overrides."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = cfg.with_(attn_impl="xla_cv" if shape.kind == TRAIN else "pallas")
    if shape.kind != TRAIN:
        cfg = cfg.with_(param_dtype="bfloat16")
    if remat:
        cfg = cfg.with_(remat=remat)
    if overrides:
        cfg = cfg.with_(**overrides)
    return cfg


def resident_bytes(model, shape: ShapeSuite) -> Dict[str, int]:
    """Bytes the cell holds whatever its part: the parameters (their own
    dtype); for ``train_*`` their gradients (the same dtype) and the two fp32
    AdamW moments; for prefill and decode one sequence's cache."""
    params, _ = model.init(abstract=True)
    leaves = list(tree_leaves(params))
    p_bytes = sum(x.numel() * x.element_size() for x in leaves)
    out = {"params": p_bytes}
    if shape.kind == TRAIN:
        out["grads"] = p_bytes
        out["moments"] = 8 * sum(x.numel() for x in leaves)
    else:
        out["cache_one_sequence"] = model.cache_bytes(1, shape.seq_len)
    out["total"] = sum(out.values())
    return out


def part_bytes_per_sequence(model, shape: ShapeSuite) -> int:
    """The estimate ``k`` is chosen by: device bytes one sequence of a part
    adds at its peak, bf16 activations.

    * ``train_*``: the layer inputs remat keeps, ``L x S x D x 2`` times the
      reference's family factor (MoE 2, SSM and hybrid 3); 16 live tensors of
      the widest activation of one layer in its recompute and backward
      (``width``); and 16 bytes a logit (bf16 logits, their fp32 copy for the
      loss, the fp32 and bf16 gradients).
    * prefill: the returned cache and 8 live tensors of the widest
      activation, in fp32 for the SSM families (their conv, gate and norm
      run in fp32), whose SSD kernels also hold their scratch states
      (``B x nc x nh x hp x N``, fp32 and bf16).
    * decode: the cache, four fp32 copies of one layer's K and V (the plain
      decode attention upcasts them) and three fp32 score rows a head.
    """
    cfg = model.cfg
    S, D, L = shape.seq_len, cfg.d_model, cfg.num_layers
    k_cf = cfg.experts_per_token * cfg.capacity_factor if cfg.num_experts else 0
    width = max(D, cfg.d_ff or 0, int(k_cf * D), int(k_cf * (cfg.d_ff or 0)),
                2 * cfg.d_inner + 2 * cfg.ssm_state if cfg.ssm_state else 0,
                (cfg.num_heads + 2 * cfg.num_kv_heads) * (cfg.head_dim or 0))
    if shape.kind == TRAIN:
        fam = {"moe": 2.0, "ssm": 3.0, "hybrid": 3.0}.get(cfg.family, 1.0)
        return int(L * S * D * 2 * fam + 16 * S * width * 2
                   + 16 * S * cfg.vocab_size)
    cache = model.cache_bytes(1, shape.seq_len)
    if shape.kind == PREFILL:
        if not cfg.ssm_state:
            return int(cache + 8 * S * width * 2)
        scratch = -(-S // 64) * cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * 6
        return int(cache + 8 * S * width * 4 + scratch)
    layer_kv = 2 * S * max(cfg.num_kv_heads, 1) * (cfg.head_dim or 0) * 4
    return int(cache + 4 * layer_kv + 3 * max(cfg.num_heads, 1) * S * 4)


def choose_parts(batch: int, per_seq: int, free_bytes: Optional[float]) -> int:
    """The smallest power of two ``k`` dividing ``batch`` whose part
    (``batch / k`` sequences) fits ``PART_SHARE`` of ``free_bytes`` by
    ``per_seq``; ``batch`` itself (one sequence a part) if none does. No
    limit (``free_bytes`` None): 1."""
    k = 1
    if free_bytes is None:
        return k
    while (batch // k) * per_seq > PART_SHARE * free_bytes and batch % (2 * k) == 0:
        k *= 2
    return k


@functools.lru_cache(maxsize=1)
def card_line() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def free_device_bytes(device: torch.device) -> Optional[float]:
    """Device bytes a part may still take: free on the card plus what the
    caching allocator holds unused; None on the CPU (no limit)."""
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return float(free + torch.cuda.memory_reserved(device)
                 - torch.cuda.memory_allocated(device))


def _time_ms(fn: Callable, device: torch.device, iters: int):
    """ms of ``iters`` calls after ``WARMUP``: CUDA events on the card, the
    host clock on the CPU."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(iters):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _sites(sites, n):
    return [{"op": s.op_name[-120:], "value": s.value, "x": s.multiplier}
            for s in sites[:n]]


def _auto_microbatches(model, shape: ShapeSuite, mesh,
                       budget_bytes: float = 3 * GiB) -> int:
    """The reference's split of a mesh cell's batch, so that per-device
    layer-boundary activations fit: saved activations ~ L x B_local x S x D
    x 2 bytes (bf16, replicated over the model axis), with family factors
    for the extra live state of MoE capacity buffers and SSD intra-chunk
    tensors. Grows in powers of two while the local batch stays
    divisible."""
    cfg = model.cfg
    axes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    data_shards = axes.get("data", 1) * axes.get("pod", 1)
    if model.pol.profile == "fsdp_only":  # the batch on the joint axes
        data_shards *= axes.get("model", 1)
    b_local = max(1, shape.global_batch // data_shards)
    factor = {"moe": 2.0, "ssm": 3.0, "hybrid": 3.0}.get(cfg.family, 1.0)
    act = cfg.num_layers * b_local * shape.seq_len * cfg.d_model * 2 * factor
    mb = 1
    while act / mb > budget_bytes and b_local % (2 * mb) == 0:
        mb *= 2
    return mb


def _local_bytes(tree) -> int:
    return sum(local(x).numel() * local(x).element_size()
               for x in tree_leaves(tree))


def _local_rows(batch) -> int:
    """Sequences of this rank's local batch (a VLM's has no tokens)."""
    return local(batch["tokens"] if "tokens" in batch
                 else batch["embeds"]).shape[0]


def _first_part(batch, k: int):
    """The first of ``k`` microbatches of each rank's local batch."""
    if k == 1:
        return batch
    from repro_torch.train.train_step import _split_local
    return {n: _split_local(x, 1 if n == "positions" else 0, k)[0]
            for n, x in batch.items()}


def measure_cell(arch: str, shape_name: str, *, device="cuda",
                 reduced: bool = False, remat: Optional[str] = None,
                 overrides: Optional[Dict] = None,
                 budget_bytes: Optional[int] = None,
                 iters: int = ITERS, mesh: str = "single",
                 rank: int = 0) -> Dict:
    """Run, count and time one cell; returns its record. ``budget_bytes``:
    the device memory the resident state must fit (default: the card's
    total; none on the CPU). ``iters``: the timed calls, fewer to keep
    the CPU tests short. Weights and batch come from seed 0. ``mesh``:
    ``"single"`` (one card) or a production mesh (``MESHES``), run as
    ``rank``'s shard under a fake world (``measure_mesh_cell``)."""
    if mesh != "single":
        return measure_mesh_cell(arch, shape_name, mesh, device=device,
                                 reduced=reduced, remat=remat,
                                 overrides=overrides, iters=iters, rank=rank)
    device = resolve_device(device)
    shape = get_shape(shape_name)
    overrides = dict(overrides or {})
    forced_k = overrides.pop("microbatches", None)
    grad_compression = overrides.pop("grad_compression", None)
    run_shape = reduced_shape(shape) if reduced else shape
    cfg = cell_config(arch, run_shape, reduced=reduced, remat=remat,
                      overrides=overrides)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    model = build_model(cfg, device)
    resident = resident_bytes(model, run_shape)
    if budget_bytes is None and device.type == "cuda":
        budget_bytes = torch.cuda.get_device_properties(device).total_memory
    rec = {"arch": arch, "shape": shape_name, "mesh": "1", "n_devices": 1,
           "device": device.type, "reduced": reduced,
           "seq_len": run_shape.seq_len, "global_batch": run_shape.global_batch,
           "attn_impl": cfg.attn_impl, "remat": cfg.remat,
           "param_dtype": cfg.param_dtype, "resident_bytes": resident}
    if grad_compression is not None:
        rec["grad_compression"] = ("one device: the plain step, as the "
                                   "reference's without a pod axis")
    if budget_bytes is not None and resident["total"] > budget_bytes:
        rec["skipped"] = (f"resident state {resident['total']} B exceeds the "
                          f"device's {budget_bytes} B even at one sequence")
        rec["budget_bytes"] = budget_bytes
        return rec

    t0 = time.time()
    gen = torch.Generator(device=device).manual_seed(0)
    params, _ = model.init(gen)
    opt = adamw.init(params) if run_shape.kind == TRAIN else None
    per_seq = part_bytes_per_sequence(model, run_shape)
    B = run_shape.global_batch
    k = int(forced_k) if forced_k else choose_parts(B, per_seq,
                                                    free_device_bytes(device))
    if B % k:
        raise ValueError(f"global batch {B} does not split into {k} parts")
    part = ShapeSuite(run_shape.name, run_shape.kind, run_shape.seq_len, B // k)
    batch = model.synthetic_batch(part, gen)
    if run_shape.kind == TRAIN:
        part_fn = lambda: _accumulate_grads(model, params, batch, 1)
    elif run_shape.kind == PREFILL:
        part_fn = lambda: model.forward(params, batch, return_cache=True,
                                        last_token_only=True)
    else:
        cache = model.init_cache(part.global_batch, part.seq_len)
        batch["pos"] = torch.full((), part.seq_len - 1, dtype=torch.int32,
                                  device=device)
        part_fn = lambda: model.decode(params, cache, batch)
    rec["setup_s"] = round(time.time() - t0, 3)
    update = None
    if run_shape.kind == TRAIN:
        opt_cfg = adamw.AdamWConfig()
        update = lambda grads: adamw.update(opt_cfg, grads, opt, params)
    _measure(rec, model, run_shape, part_fn, update, k, device, iters,
             n_chips=1, part_sequences=part.global_batch,
             part_estimate_bytes=per_seq * part.global_batch)
    return rec


class _OnceAWorld(logging.Filter):
    """DTensor warns, once per redistribution, that a change on several
    mesh axes at once (a dim split over ("data", "model"), a sum over every
    axis) takes one collective an axis: the counted collectives say so
    already."""

    def filter(self, record):
        return "sequential all_" not in record.getMessage()


def measure_mesh_cell(arch: str, shape_name: str, mesh_kind: str, *,
                      device="cuda", reduced: bool = False,
                      remat: Optional[str] = None,
                      overrides: Optional[Dict] = None,
                      iters: int = ITERS, rank: int = 0) -> Dict:
    """One device's shard of a cell on a production mesh (``"pod"``: the
    reference's 16 x 16 ``single``; ``"multi"``: 2 x 16 x 16), run on this
    device as ``rank`` of a fake world of the mesh's size
    (``launch.mesh.fake_world``): the model built on the mesh, parameters,
    batch and cache drawn as that rank's local shards, the step counted and
    timed. Collectives are counted by the bytes each device's would move,
    not performed, so the values (the loss among them) are undefined. A
    training cell splits the local batch into the reference's
    ``_auto_microbatches`` parts (``--set microbatches=N`` forces it) and
    counts one; ``grad_compression`` syncs over "pod" after the parts, as
    the reference's step. A cell whose policy needs a part the mesh does
    not run yet raises, naming its ROADMAP item."""
    device = resolve_device(device)
    shape = get_shape(shape_name)
    overrides = dict(overrides or {})
    forced_k = overrides.pop("microbatches", None)
    grad_compression = bool(overrides.pop("grad_compression", False))
    run_shape = reduced_shape(shape) if reduced else shape
    cfg = cell_config(arch, run_shape, reduced=reduced, remat=remat,
                      overrides=overrides)
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": reason}
    multi = mesh_kind == "multi"
    logging.getLogger("torch.distributed.tensor._redistribute").addFilter(
        _OnceAWorld())
    with fake_world(math.prod(MESHES[mesh_kind]), rank=rank):
        dmesh = make_production_mesh(multi_pod=multi, device_type=device.type)
        model = build_model(cfg, dmesh)
        tfm.require_on_mesh(cfg, model.pol)
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "x".join(map(str, dmesh.shape)),
               "n_devices": dmesh.size(), "device": device.type,
               "rank": rank,
               "coords": {a: dmesh.get_local_rank(a)
                          for a in dmesh.mesh_dim_names},
               "reduced": reduced, "seq_len": run_shape.seq_len,
               "global_batch": run_shape.global_batch,
               "attn_impl": cfg.attn_impl, "remat": cfg.remat,
               "param_dtype": cfg.param_dtype,
               "policy": dataclasses.asdict(model.pol),
               "note": (f"rank {rank}'s shard of the step on the "
                        f"{'x'.join(map(str, dmesh.shape))} mesh, run on one "
                        f"device under a fake process group of "
                        f"{dmesh.size()} ranks: collectives were counted by "
                        f"the bytes each device's would move, not run, so "
                        f"every value they feed is undefined; the part timed "
                        f"over {iters} call{'s' if iters != 1 else ''} after "
                        f"{WARMUP} warm-up")}
        if cfg.family == MOE:
            # the experts this rank holds: E / model where that axis
            # splits them (expert parallelism), else all of them
            split = (model.env.size(model.env.tp)
                     if model.pol.experts_sharded else 1)
            rec["experts_sharded"] = model.pol.experts_sharded
            rec["experts_local"] = cfg.num_experts // split
        if cfg.family in (SSM, HYBRID):
            # the SSM heads this rank's scan runs: nh / model where that
            # axis splits them, else all of them
            split = (model.env.size(model.env.tp)
                     if model.pol.ssm_sharded else 1)
            rec["ssm_sharded"] = model.pol.ssm_sharded
            rec["ssm_heads_local"] = cfg.ssm_heads // split
        t0 = time.time()
        gen = torch.Generator(device=device).manual_seed(0)
        params, _ = model.init(gen)
        batch = model.synthetic_batch(run_shape, gen)
        k, update = 1, None
        if run_shape.kind == TRAIN:
            k = int(forced_k) if forced_k else _auto_microbatches(
                model, run_shape, dmesh)
            b_local = _local_rows(batch)
            if b_local % k:
                raise ValueError(f"local batch {b_local} does not split into "
                                 f"{k} parts")
            part_batch = _first_part(batch, k)
            opt = adamw.init(params)
            opt_cfg = adamw.AdamWConfig()
            part_fn = lambda: _accumulate_grads(model, params, part_batch, 1)
            err = (compression.init_error_feedback(params)
                   if grad_compression and multi else None)

            def update(grads):
                if err is not None:
                    grads, _ = compression.cross_pod_sync(grads, err, dmesh,
                                                          compress=True)
                return adamw.update(opt_cfg, grads, opt, params)
            rec["grad_compression"] = (
                "int8 + error feedback over the pod axis, after the "
                "gradients' reduction over it (the reference's build)"
                if err is not None else ("no pod axis: the plain step"
                                         if grad_compression else None))
            rec["loss_note"] = ("not checked: a fake world's collectives "
                                "leave their outputs undefined")
        elif run_shape.kind == PREFILL:
            part_fn = lambda: model.forward(params, batch, return_cache=True,
                                            last_token_only=True)
        else:
            cache = model.init_cache(run_shape.global_batch, run_shape.seq_len)
            local(batch["pos"]).fill_(run_shape.seq_len - 1)
            part_fn = lambda: model.decode(params, cache, batch)
        rec["resident_bytes"] = {"params_local": _local_bytes(params)}
        rec["setup_s"] = round(time.time() - t0, 3)
        _measure(rec, model, run_shape, part_fn, update, k, device, iters,
                 n_chips=dmesh.size(),
                 part_sequences=_local_rows(batch) // k,
                 part_estimate_bytes=None)
    return rec


def _measure(rec: Dict, model, run_shape: ShapeSuite, part_fn, update, k: int,
             device: torch.device, iters: int, *, n_chips: int,
             part_sequences: int, part_estimate_bytes) -> None:
    """Counts and times ``part_fn`` (and ``update`` of its gradients for a
    training cell) and fills ``rec`` with the step of ``k`` parts."""
    cfg = model.cfg
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    before = {n: w.launches for n, w in WRAPPERS.items()}
    t1 = time.time()
    out, part_cost = count_step(part_fn)
    rec["count_s"] = round(time.time() - t1, 3)
    wrapper_launches = {n: w.launches - before[n] for n, w in WRAPPERS.items()
                        if w.launches != before[n]}
    cost = part_cost.scaled(k)
    update_ms = None
    if update is not None:
        if "loss_note" not in rec:
            rec["loss"] = float(out[0])
            if cfg.learned_pos and run_shape.seq_len > cfg.max_position:
                rec["loss_note"] = (
                    f"NaN by design: positions past the {cfg.max_position} "
                    f"learned ones read NaN rows, as the reference's "
                    f"jnp.take; the step's times are not a trained step's")
        grads = out[1]
        _, update_cost = count_step(update, grads)
        cost = cost + update_cost
        update_ms = _time_ms(lambda: update(grads), device, iters)
        del grads
    del out
    part_ms = _time_ms(part_fn, device, iters)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)

    terms = analyze(cost, n_chips, model_flops_for(cfg, run_shape),
                    loop_trip_count=cfg.num_layers,
                    host_bytes_per_step=cost.host_bytes * n_chips)
    rec["microbatches"] = k
    rec["roofline"] = terms.as_dict()
    rec["collectives"] = {"bytes_by_op": terms.collectives.bytes_by_op,
                          "count_by_op": terms.collectives.count_by_op,
                          "loop_trips": []}
    rec["host_bytes"] = cost.host_bytes
    rec["top_sites"] = {"flops": _sites(cost.top_flops_sites, 8),
                        "collective": [dict(s, kind=c.kind) for s, c in zip(
                            _sites(cost.top_collective_sites, 8),
                            cost.top_collective_sites)],
                        "bytes": _sites(cost.top_bytes_sites, 10)}
    rec["kernels"] = {
        "launches": cost.kernel_launches,
        "launches_by_route": cost.kernel_launches_by_route,
        "flops": cost.kernel_flops, "bytes": cost.kernel_bytes,
        "counted_pass": {"count": part_cost.kernel_launches,
                         "routes": part_cost.kernel_launches_by_route,
                         "wrappers": wrapper_launches}}
    rec["ops"] = cost.ops
    resident = rec.get("resident_bytes", {})
    rec["memory"] = {"resident_gib": resident.get(
                         "total", resident.get("params_local", 0)) / GiB,
                     "part_estimate_gib": (None if part_estimate_bytes is None
                                           else part_estimate_bytes / GiB),
                     "per_device_gib": (peak / GiB if peak is not None
                                        else None)}
    part_med = statistics.median(part_ms)
    upd = statistics.median(update_ms) if update_ms else 0.0
    step_ms = k * part_med + upd
    tokens = run_shape.tokens_per_step / n_chips
    model_flops = model_flops_for(cfg, run_shape) / n_chips
    rec["measured"] = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "card": card_line() if device.type == "cuda" else None,
        "timer": "CUDA events" if device.type == "cuda" else "host clock",
        "calls": iters, "warmup": WARMUP,
        "part_sequences": part_sequences, "k": k,
        "part_ms_median": part_med, "part_ms_min": min(part_ms),
        "part_ms_max": max(part_ms),
        "update_ms": upd if update_ms else None,
        "step_ms": step_ms,
        "tokens_per_s": tokens / (step_ms * 1e-3) if step_ms else None,
        "peak_device_bytes": peak,
        "mfu": (model_flops / (step_ms * 1e-3 * H100_BF16_PEAK_FLOPS)
                if device.type == "cuda" and step_ms else None),
        "mfu_peak_flops": H100_BF16_PEAK_FLOPS,
        "mfu_peak": "NVIDIA H100 SXM datasheet, dense BF16 tensor cores",
    }
    if n_chips > 1:
        rec["measured"]["per_device"] = (
            "this device's shard: tokens_per_s and mfu are the global step's "
            "divided by the mesh's devices")
    rec["ran"] = True


def run_cell(arch: str, shape_name: str, out_dir: str, *,
             remat: Optional[str] = None, overrides: Optional[Dict] = None,
             tag: str = "", **kwargs) -> Dict:
    """``measure_cell`` into ``<out_dir>/<arch>__<shape>[__tag].json``; a
    failure is written as an ``error`` record, as the reference's."""
    try:
        rec = measure_cell(arch, shape_name, remat=remat, overrides=overrides,
                           **kwargs)
    except Exception as e:  # noqa: BLE001 - report, don't crash the sweep
        mesh = kwargs.get("mesh", "single")
        rec = {"arch": arch, "shape": shape_name,
               "mesh": "x".join(map(str, MESHES[mesh])) if mesh in MESHES
               else "1", **({"rank": kwargs.get("rank", 0)} if mesh in MESHES
                            else {}),
               "error": f"{type(e).__name__}: {e}",
               "trace": traceback.format_exc()[-2000:]}
    gc.collect()
    if torch.cuda.is_available():
        try:
            torch.cuda.empty_cache()
        except RuntimeError as e:       # a device fault makes this raise too
            rec.setdefault("cleanup_error", f"{type(e).__name__}: {e}")
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    with open(os.path.join(out_dir, f"{arch}__{shape_name}{suffix}.json"),
              "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def summarize(rec: Dict) -> str:
    if rec.get("skipped"):
        return f"SKIP  {rec['arch']:24s} {rec['shape']:12s} ({rec['skipped'][:60]})"
    if rec.get("error"):
        return f"FAIL  {rec['arch']:24s} {rec['shape']:12s} {rec['error'][:80]}"
    r, m = rec["roofline"], rec["measured"]
    mfu = f"{m['mfu'] * 100:5.1f}%" if m["mfu"] is not None else "  n/a"
    return (f"OK    {rec['arch']:24s} {rec['shape']:12s} k={m['k']:<3d} "
            f"step={m['step_ms']:10.2f}ms tok/s={m['tokens_per_s']:12.1f} "
            f"mfu={mfu} flops={r['hlo_flops_per_chip']:.3e} "
            f"bytes={r['hlo_bytes_per_chip']:.3e} "
            f"useful={r['useful_flops_ratio'] * 100:5.1f}%")


def parse_overrides(items) -> Dict:
    """``--set k=v`` values, cast as the reference casts them."""
    overrides = {}
    for kv in items:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("True", "true"):
            v = True
        if v in ("False", "false"):
            v = False
        overrides[k] = v
    return overrides


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=sorted(MESH_KINDS),
                    help="single: one card; pod: 16x16 (the reference's "
                         "single); multi: 2x16x16; both: pod and multi")
    ap.add_argument("--rank", type=int, default=0,
                    help="on a mesh: the rank whose shard runs (rank r of a "
                         "16x16 mesh is data r // 16, model r % 16)")
    ap.add_argument("--all", action="store_true",
                    help="sweep all assigned (arch x shape) cells")
    ap.add_argument("--include-paper-archs", action="store_true")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. microbatches=4)")
    ap.add_argument("--tag", default="", help="record filename suffix")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config and shape (CPU runs)")
    args = ap.parse_args(argv)
    if args.all:
        archs = ALL_ARCHS if args.include_paper_archs else ASSIGNED_ARCHS
        cells = [(a, s.name) for a in archs for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    overrides = parse_overrides(args.set)
    failures = 0
    for mesh in MESH_KINDS[args.mesh]:
        out_dir = os.path.join(args.out, mesh)
        for arch, shape in cells:
            rec = run_cell(arch, shape, out_dir, remat=args.remat,
                           overrides=overrides or None, tag=args.tag,
                           device=args.device, reduced=args.reduced,
                           mesh=mesh, rank=args.rank)
            print(summarize(rec), flush=True)
            failures += 1 if rec.get("error") else 0
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
