#!/usr/bin/env python3
"""Quickest proof that the PyTorch / CUDA port starts and is right on a GPU.

    python3 chip_smoke.py            # needs one NVIDIA H100 and nvcc

Drives the port's main path through its public entry points and prints one
JSON line per phase; any failure is a non-zero exit:

  env      torch / CUDA versions, the card's name and power limit, the
           host's RAM and the pinned-memory (memlock) limit
  build    builds every kernel under src/repro_torch/kernels/csrc with nvcc
  kernels  each kernel's wrapper against its plain PyTorch version on the
           card at the main paths' shapes, with its time, the plain
           version's, one library call's, and the card's bound for the work:
           the flash forward (serving), the forward with its lse output and
           the two backward kernels (training; the port's whole backward in
           one call beside the library's; the serving forward also at
           whisper's and qwen2-vl's decoder-prefill shapes; forward, forward
           with lse and both backward kernels at phi3-mini's head dim 96,
           (32, 1024, 96), bf16 and fp32; the forward at starcoder2-7b's
           and command-r-35b's 1,024-token prefills, (36|64, 1024, 128), and
           the training kernels at train_phi3's (8 x 32, 1024, 96),
           bf16), stream_matmul
           (each case's route, qwen2-vl's pinned layer at its decode and
           prefill shapes among them; a pinned w's rate as a share of the
           1 GiB copy's from a host-tier buffer, link_memcpy_gb_per_s, with
           the caching host allocator's beside it; the ring at several panel
           depths beside the library), ssd_scan (no single PyTorch call computes the SSD:
           no library time) and its autograd Function (gradients against
           autograd through ssd_chunked, the plain backward's time at the
           training shapes), grouped_matmul (library: torch.bmm) with w on
           the card and in pinned host memory, its two backward products at
           granite-moe's training shapes, the pinned decode at four panel
           depths (granite-moe's and phi3.5-moe's), phi3.5-moe's path shapes
           (decode and 1,024-token prefill, w_gate from a host-tier buffer,
           w_in and w_out on the card), and the host time of one wrapper
           call beside its library call's
  serve    llama3-8b at full width and depth (random bf16 weights from a
           seed) through ServingEngine.run; the kernel launch counts are set
           to 0 just before and read just after
  check    full-width logits through the kernel against the eager chunked
           attention, and prefill -> decode against the full forward
  offload  the same requests with the KV pool on the device, split by an
           OffloadPlan, and fully in pinned host memory: identical tokens
  runtime  SliceRuntime with two tenants: llama3-8b at full width and depth
           on 2s.32c with an HBM budget that spills the embedding table, the
           KV pool and one stacked MLP matrix to pinned host memory (the
           matrix streamed through stream_matmul in every prefill and tick),
           next to gpt2-124m on 1s.16c; the counts are set to 0 just before
           SliceRuntime.run and read just after, every stream_matmul launch
           checked to take the route stream_matmul.plan gives it (here,
           hybrid and moe_runtime)
  gpt2     gpt2-124m at full size (layernorm, learned positions, tanh-GELU,
           biases, tied embeddings)
  serve_starcoder2, serve_command_r
           starcoder2-7b (GQA groups of 9, biased GELU MLP) and command-r-35b
           (60.6 GB of bf16 weights, GQA groups of 8, rope theta 8e6, the
           256,000-wide unembedding through its tied token table) at full
           size, each alone on the card, driven as the serve phase drives
           llama3-8b: every prefill's flash launch (admitted x layers, all
           wgmma), then the check phase's logit checks on the same parameter
           tensors; the model freed, device memory back within 64 MiB
  train    gpt2-124m at full size trained through launch/train.py's path
           (FaultTolerantRunner, StaticPartitioner, checkpoints): 30 AdamW
           steps of 8 x 1024 tokens, attention through the flash forward and
           backward kernels, one injected chip failure (restore + repartition);
           the counts are set to 0 just before and read just after, every
           flash launch (forward and both backward kernels) checked to take
           the bf16 wgmma route
  grads    one step's loss and gradients of full gpt2-124m through the kernels
           against the eager attention, and the remat routes none / offload
           against layer (equal), with the offload route's host bytes
  train_ssm, train_hybrid, train_moe, train_phi3
           mamba2-130m, zamba2-1.2b, granite-moe-1b-a400m and phi3-mini-3.8b
           (head dim 96) at full size trained through launch/train.py's
           path: 8, 12, 8 and 8 AdamW steps of 8 x 1024 tokens, remat
           "layer", attention through the flash kernels,
           every prefill SSD through ssd_scan (the SSD Function's backward
           is plain torch) and every expert product, forward and backward,
           through grouped_matmul; the counts are set to 0 just before and
           read just after and must equal the remat nesting's formulas, every
           bf16 launch on the wgmma route; one step's loss and gradients
           through the kernels against the plain routes on the card (fp32,
           the SSM families' at a cut depth where fp32 rounding allows 1e-4)
  ssm      mamba2-130m at full size (random bf16 weights from a seed) through
           ServingEngine.run, every prefill's SSD through the ssd_scan kernel
           (counts set to 0 just before, read just after); prefill -> decode
           against the full forward, one layer through the kernel against
           the same layer with the plain ssd_chunked, and the pool fully in
           pinned host memory giving identical tokens, the state kept fp32
  hybrid   zamba2-1.2b at full size through SliceRuntime.add_tenant with an
           HBM budget that spills the KV and state pools and one stacked SSM
           projection (streamed through stream_matmul); the shared attention
           block's prefill through the flash kernel; tokens against a lone
           engine on the same placement, and, in fp32 activations, against
           one with every weight on the device
  moe      granite-moe-1b-a400m at full size (random bf16 weights from a seed)
           through ServingEngine.run, every expert product through
           grouped_matmul (counts set to 0 just before, read just after);
           the capacity and dropped share of a 1024-token prefill, and
           prefill -> decode against the full forward
  moe_runtime  the same model through SliceRuntime.add_tenant with an HBM
           budget that spills the table, the KV pool and one expert stack
           (streamed through grouped_matmul from pinned memory); tokens
           against a lone engine on the same placement and, in fp32
           activations, against one with every weight on the device
  encdec   whisper-large-v3 at full size (32 + 32 layers, 1500 frames from
           the stubbed audio front end): 4 requests, each prefilled alone
           through Model.forward and pasted into a 4-slot KVPool (max_seq
           448, whisper's text context; the cross K/V held whole), then decoded together with
           per-row pos; the decoder's causal prefill through the flash kernel
           (counts set to 0 just before, read just after; 4 x 32 launches,
           all wgmma); encoder and decoder-prefill ms apart; logits against
           the eager attention, and each request's first decode step against
           the full forward of its prompt and one token; then 4 more ticks
           and the longest prompt's prefill under torch.profiler (device-busy
           ms, idle share, the top device ops)
  vlm      qwen2-vl-72b at full width and all 80 layers (145.4 GB of bf16
           weights), alone on the card: plan_offload against the card's free
           memory and the host's MemAvailable puts the token table, the KV
           pool and the gate and input MLP stacks (82,686,509,056 bytes) in
           pinned host memory, failing before any allocation if the plan or
           the host cannot hold it; each parameter drawn straight into its
           tier (every leaf checked in its tier, the host bytes taken read
           from MemAvailable within 2% of the plan's, the init's
           device peak at most the resident bytes and one host leaf); 4
           requests laid out as Qwen2-VL lays out one image (text, a gh x gw
           block of stubbed vision embeddings, text) with three M-RoPE
           position streams, whose positions fall below the cache index
           after the image, served through a KVPool placed by the plan; the
           counts set to 0 just before and read just after: flash launches
           = prefills x 80 (all wgmma), stream_matmul launches = passes x
           160 (all ring) and its bytes = passes x 77,510,737,920, the
           table rows' bytes; the encdec phase's logit checks and profiles;
           device memory back within 64 MiB and MemAvailable within 2 GiB
  moe_full phi3.5-moe-42b-a6.6b at full width and all 32 layers (83.7 GB of
           bf16 weights, 16 experts, top-2), alone on the card, through
           SliceRuntime.add_tenant with the HBM budget the vlm phase reckons
           (the card's free memory less the KV pool and a prefill's
           headroom): the plan, checked first against MemAvailable, puts the
           token table, the KV pool and the gate expert stack
           (28,179,955,712 bytes) in pinned host memory, each parameter
           drawn straight into its tier (every leaf checked in its tier, the
           host bytes taken within 2% of the plan's, the init's device peak
           the resident bytes within 64 MiB); the moe phase's 8 requests
           through SliceRuntime.run, the counts set to 0 just before and
           read just after: flash launches = prefills x 32, grouped_matmul
           launches = passes x 96 (all wgmma), its streamed bytes = passes x
           26,843,545,600, no stream_matmul launch, the table rows' bytes;
           the 1,024-token prompt's dropped share at capacity 160 and its
           logits through the kernels against the eager attention, each
           request's first decode step against the full forward at the
           no-drop capacity factor, both in fp32 activations on the same
           bf16 tensors (the bf16 figures printed beside them: a rounding
           that flips a near-tied routing decision moves the drops); device
           memory back within 64 MiB and MemAvailable within 2 GiB
  cluster  the port's ClusterScheduler (frag_repack, one modelled pod)
           driving a crafted trace with its serving jobs executed as live
           SliceRuntime tenants on the card at full width and depth
           (attn_impl "pallas"): gpt2-124m, phi3-mini-3.8b (head dim 96) and
           llama3-8b together beside a modelled mamba2-130m batch job, then
           qwen3-32b (65.5 GB) alone; the timeline's sha against the same
           trace run here by the port on the CPU with reduced tenants, every
           serving job's tokens (requests x max_new) and finite first-decode
           logits, the flash launches (counts set to 0 just before, read just
           after: requests x layers a tenant, all wgmma), every tenant freed
           (chips, and device memory back within 64 MiB); per tenant
           add_tenant and drain seconds, tok/s, and the peak device memory
  dryrun   launch/dryrun.py's measured dry run at full size into a temporary
           directory: gpt2-124m and granite-moe-1b-a400m train_4k, llama3-8b
           prefill_32k and decode_32k, mamba2-130m prefill_32k and long_500k;
           each cell runs, counts (core.step_analysis) and times one part of
           its global batch; checked: the count's kernel launches equal the
           wrappers' counts in the counted pass (and the cell's launches are
           that times its passes), the kernels each cell must reach and no
           other, every bf16 flash and grouped_matmul launch on wgmma, finite
           records, a finite training loss (gpt2-124m's NaN where its 4,096
           positions pass its 1,024 learned ones, as the reference's, and
           the record says so), PerfModel.from_artifacts loading every cell
           and scoring it calibrated; per cell the counted TFLOP, HBM GB and
           host GB, useful_flops_ratio, the calibration ratios against the
           analytic WorkloadEstimate, k, step ms, tokens/s, MFU (against the
           H100 datasheet's dense bf16 peak) and peak device bytes. Then the
           kernels at the shapes the cells' parts gave them, on finite inputs
           against their plain versions with their route checks: the flash
           training kernels at each train_4k part (heads x 4,096 tokens),
           grouped_matmul forward, dx and dw at granite-moe's capacity rows,
           ssd_scan at the mamba2 prefill_32k part. The kernels phase holds
           the flash forward at (2, 32768, 128) bf16 causal and ssd_scan at
           32,768-token rows against their plain versions
  mesh     the reference's sharded step on its production meshes, in a
           child process (python3 chip_smoke.py --mesh-child DIR) so its
           fake process group never touches the other phases: llama3-8b
           train_4k and prefill_32k on 16x16, gpt2-124m train_4k on
           2x16x16 (fsdp_only, grad_compression over "pod") and decode_32k
           on 16x16 (the cache split by sequence), as rank 0; starcoder2-7b
           train_4k and prefill_32k and whisper-large-v3 train_4k on 16x16
           as rank 15, the last model rank (sequence-parallel attention:
           the heads whole, the sequence split over "model", each layer's
           K/V gathered and the rank's queries attending at their offset,
           whisper's 1,500 encoder frames split 94 / 90); qwen2-vl-72b
           prefill_32k as rank 0 (Megatron SP: 4 of 64 heads, the residual
           stream split by sequence between tensor-parallel regions);
           granite-moe-1b-a400m train_4k and phi3.5-moe-42b-a6.6b
           prefill_32k and decode_32k as rank 0 (expert parallelism: 2 of 32
           and 1 of 16 experts a rank, the routing global, grouped_matmul on
           the local experts' capacity buffers, the exit summing the ranks);
           mamba2-130m train_4k (fsdp_only: one sequence a device, all 24
           SSM heads) and zamba2-1.2b train_4k and prefill_32k as rank 0
           (4 of 64 SSM heads a rank, ssd_scan on the local heads, the
           gated norm summed over the ranks; the shared block's 2 of 32
           heads); each at full width and depth as one device's shard through
           launch/dryrun.py (a fake world: collectives counted, not run;
           values undefined); the flash and grouped_matmul counts set to 0
           just before each cell and read just after, equal to the passes x
           the counted pass, a pass launching each flash kernel once a
           (decoder) layer (the forward twice under remat) and
           grouped_matmul once an expert product a layer (3 a layer, 12 a
           training layer: two forwards, dx and dw), all wgmma, the flash
           kernels at the local shapes (q's, k's and the query offset:
           B_part x local heads, the rank's query block), every
           grouped_matmul launch on a stack of the rank's E/16 experts, its
           forwards at the local capacity rows (groups x C, or the decode's
           rows with one shared x); ssd_scan once an SSM layer's forward
           (a hybrid group's three times a training pass, a tail layer's
           twice), every launch at the rank's rows and SSM heads; every
           record loaded by PerfModel.from_artifacts; per cell part and step ms, per-device
           TFLOP, HBM GB and collective GB by op, and the FLOP ratio to the
           reference's committed per-chip anchor where there is one,
           printed not gated; then B1 / B3 / B4 at those local shapes
           against their plain versions, with SDPA under the bottom-right
           causal mask as the library call for a query block at its offset,
           and grouped_matmul at the MoE cells' local shapes (forwards, and
           dx / dw at the training rows) with torch.bmm as the library call,
           and ssd_scan at the SSM cells' local shapes (mesh_local in the
           kernels line). Then serving cells in the same child: llama3-8b
           through SliceRuntime(mesh=...) (MESH_SERVE_CELLS), and
           whisper-large-v3 prefilled, pooled and decoded as one rank's shard
           (MESH_ENCDEC_CELLS: rank 0 of (1, 4), 5 of 20 heads, decoder/w_in
           and the tied head's table streamed from pinned memory; rank 4 of
           (1, 8), sequence-parallel); each cell's launches held to their
           formulas at the local shapes, and B1 and B2 then held there
           against their plain versions (mesh_serve_local)

Then a line {"kernels": [...]} with every kernel's figures, the card's name
and power limit, and last {"ok": true, "device": {...}}.

Timing: CUDA events around single launches after a warm-up, median of 20;
inputs stay in the L2 cache between launches, as they do for the real caller
whose previous kernels just wrote them. The card waits for each call to end
before the next, so ``ms`` is one call from an idle card: the wrapper's host
work before the launch, then the kernel. ``cold_ms`` writes a 256 MB buffer
before each launch, outside the timed events: the inputs come from HBM (an
expert stack of 33.5 MB fits the 50 MB L2, so the warm figure alone can read
below the HBM bound, while on the main path 72 stacks pass a tick), and the
write keeps the card busy while the host prepares the call, so the figure is
the kernel's time alone. bound_ms is the larger of bytes moved
(each input read once, the output written once) over 3.35 TB/s and operations
over the peak rate of the input type (989 TFLOP/s bf16 on the tensor cores,
67 TFLOP/s fp32), the published H100 SXM figures. For a weight in pinned host
memory the bytes of the weight cross the host link; its bound is the larger
of those bytes over the link's peak rate and the device bound. The peak is
that of the card's published host interface, PCIe Gen5 x16 (lanes x transfer
rate x line-code efficiency, one direction: 63.0 GB/s); the rate one 1 GiB
pinned -> device copy reaches between CUDA events is printed beside it.
"""
from __future__ import annotations

import gc
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

SEED = 0
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 2e-5}     # max |diff| / max |plain|
# the training kernels: out as the forward; lse fp32 sums in both types; the
# gradients at the reference's backward tolerance in fp32
TRAIN_TOL = {"bfloat16": {"out": 2e-2, "lse": 2e-5, "grad": 2e-2},
             "float32": {"out": 2e-5, "lse": 2e-5, "grad": 1e-4}}
# stream_matmul and grouped_matmul: the reference's fp32 tolerance
# (tests/test_kernels.py), and one bf16 rounding of the output in bf16
STREAM_TOL = {"bfloat16": 2e-2, "float32": 1e-5}
# ssd_scan: y at the reference's fp32 SSD tolerance, one bf16 rounding in
# bf16; the final state is summed in fp32 in both
SSD_TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_STATE_TOL = 1e-4
# whole-model logits in bf16 through up to 32 layers, two routes whose bf16
# roundings fall at different places: max |diff| / max |logit|
MODEL_TOL = 5e-2
# whole-model logits with fp32 activations through up to 38 layers, two
# routes whose products sum in different orders (bf16's roundings move a
# random-init SSM model's logits ~100x their own size: PERF.md)
FP32_MODEL_TOL = 1e-3
# the training phases: gpt2's steps, every phase's batch of T_SEQ-token
# sequences, gpt2's injected failure and checkpoint interval
T_STEPS, T_BATCH, T_SEQ, FAIL_AT, CKPT_EVERY = 30, 8, 1024, 12, 10
# PCIe transfer rate per lane in GT/s, by generation
PCIE_GT_PER_S = {1: 2.5, 2: 5.0, 3: 8.0, 4: 16.0, 5: 32.0}


def pcie_peak_bytes_per_s(gen: int, width: int) -> float:
    """Peak data rate of one direction of a PCIe link: lanes x transfer
    rate x line-code efficiency (8b/10b up to Gen2, 128b/130b from Gen3)."""
    if gen not in PCIE_GT_PER_S or width < 1:
        raise ValueError(f"no peak rate for a PCIe Gen{gen} x{width} link")
    code = 8 / 10 if gen <= 2 else 128 / 130
    return PCIE_GT_PER_S[gen] * 1e9 * width * code / 8


# the H100's host interface, PCIe Gen5 x16: a host link that trains lower
# only makes the bound looser, never too tight
HOST_LINK_BYTES_PER_S = pcie_peak_bytes_per_s(5, 16)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def host_memory() -> dict:
    """The host's RAM (``/proc/meminfo``), the locked-memory limit of this
    process (RLIMIT_MEMLOCK; CUDA's pinned allocations are not always held
    to it) and the cgroup's memory limit, where each is visible."""
    import resource
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, _, value = line.partition(":")
                if key in ("MemTotal", "MemAvailable"):
                    out[key] = value.strip()
    except OSError:
        pass
    soft, _ = resource.getrlimit(resource.RLIMIT_MEMLOCK)
    out["memlock_limit"] = ("unlimited" if soft == resource.RLIM_INFINITY
                            else soft)
    for path in ("/sys/fs/cgroup/memory.max",
                 "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(path) as f:
                out["cgroup_memory_limit"] = f.read().strip()
            break
        except OSError:
            continue
    return out


def _meminfo_bytes(path: str, key: str) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024
    raise RuntimeError(f"no {key} in {path}")


def mem_available_bytes() -> int:
    return _meminfo_bytes("/proc/meminfo", "MemAvailable")


def settled_mem_available(limit_s: float = 120.0) -> int:
    """MemAvailable once it holds still: the pages of a freed pinned buffer
    of tens of GB reach the host's free memory over seconds after its
    unregister and unmap return, so read until two readings a second
    apart differ by under 64 MiB."""
    last, t0 = mem_available_bytes(), time.time()
    while True:
        time.sleep(1.0)
        now = mem_available_bytes()
        if abs(now - last) < (64 << 20):
            return now
        if time.time() - t0 > limit_s:
            fail(f"MemAvailable still moving after {limit_s} s "
                 f"({last} -> {now} bytes)")
        last = now


# the mesh phase's cells: (arch, shape, mesh, overrides, rank, timed
# parts), each one device's shard of the reference's dry-run cell as that
# rank; the kernels each must reach. starcoder2's 36 and whisper's 20 heads
# do not divide the model axis (sequence-parallel attention): rank 15, the
# last model rank, attends the whole prefix, the heaviest rank. qwen2-vl's
# 64 heads split 4 a rank with its residuals split by sequence (Megatron
# SP); rank 0. granite-moe's 32 and phi3.5-moe's 16 experts split over the
# model axis, 2 and 1 a rank (expert parallelism); rank 0. mamba2-130m is
# fsdp_only (one of 256 sequences a device, all 24 SSM heads); zamba2-1.2b
# splits its 64 SSM heads 4 a rank and its shared block's 32 heads 2 a
# rank; rank 0. The cells after PR 30's four time one part (three took the
# phase to 176 s).
MESH_CELLS = (("llama3-8b", "train_4k", "pod", {}, 0, 3),
              ("llama3-8b", "prefill_32k", "pod", {}, 0, 3),
              ("gpt2-124m", "train_4k", "multi", {"grad_compression": True}, 0, 3),
              ("gpt2-124m", "decode_32k", "pod", {}, 0, 3),
              ("starcoder2-7b", "train_4k", "pod", {}, 15, 1),
              ("starcoder2-7b", "prefill_32k", "pod", {}, 15, 1),
              ("qwen2-vl-72b", "prefill_32k", "pod", {}, 0, 1),
              ("whisper-large-v3", "train_4k", "pod", {}, 15, 1),
              ("granite-moe-1b-a400m", "train_4k", "pod", {}, 0, 1),
              ("phi3.5-moe-42b-a6.6b", "prefill_32k", "pod", {}, 0, 1),
              ("phi3.5-moe-42b-a6.6b", "decode_32k", "pod", {}, 0, 1),
              ("mamba2-130m", "train_4k", "pod", {}, 0, 1),
              ("zamba2-1.2b", "train_4k", "pod", {}, 0, 1),
              ("zamba2-1.2b", "prefill_32k", "pod", {}, 0, 1))
MESH_TRAIN_KERNELS = {"flash_attention_fwd_stats", "flash_attention_bwd_dkdv",
                      "flash_attention_bwd_dq"}
# the reference's committed per-chip anchors (its "single" is the port's
# "pod" mesh)
ANCHOR_DIRS = {"pod": "single", "multi": "multi"}
# the mesh phase's serving cells, after the dry-run cells: llama3-8b at full
# width and depth served through SliceRuntime(mesh=...) as rank 0 of a fake
# world, with 4 slots of 2,048 positions as the serve phase has them.
# "spill": the budget one byte under what spilling the table and the KV pool
# frees (the runtime phase's rule), so the plan also puts layers/w_gate in
# the host tier and each rank streams its (32, 4096, 3584) shard of it
# through stream_matmul; rank 0 of (1, 4) holds 8 of 32 heads and 2 of 8 KV
# heads whole, the pool's sequence split over "model". "resident": every
# leaf on the card; the 4 x 4 mesh of a 1s.16c slice splits the slots over
# "data", one a rank. The planner spills the table and the pool before any
# parameter, so no budget streams a weight while it splits a KV leaf.
MESH_SERVE_CELLS = (("serve_1x4_spill", (1, 4), "spill"),
                    ("serve_4x4", (4, 4), "resident"))
MESH_SERVE_LENS, MESH_SERVE_NEW = (16, 100, 300, 1000), 8
MESH_SERVE_SLOTS, MESH_SERVE_MAX_SEQ = 4, 2048


def spill_budget(cfg, slots: int, max_seq: int) -> int:
    """The serving cells' "spill" budget: one byte under the global
    inventory less the embedding tables and the KV pool, so the plan spills
    those and then the next parameters."""
    from repro_torch.models.model_zoo import build_model
    meta = build_model(cfg, "cuda")
    inv = meta.serving_inventory(meta.init(abstract=True)[0],
                                 meta.cache_shapes(slots, max_seq))
    return (sum(t.bytes for t in inv) - 1 - sum(
        t.bytes for t in inv if t.group in ("embed", "kv_cache")))


def serve_counters():
    """The wrappers whose launches a serving cell counts, the two it counts
    by route too, and a function that sets every count and streamed byte to
    0 (just before the cell's main path)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.models import layers as mlayers
    from repro_torch.models.common import gather_param
    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
                "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "stream_matmul": sm.stream_matmul,
                "ssd_scan": ssd.ssd_scan,
                "grouped_matmul": gmm.grouped_matmul}
    routed = ("flash_attention_fwd", "stream_matmul")

    def reset():
        for w in wrappers.values():
            w.launches = 0
        for n in routed:
            wrappers[n].launches_by_route = dict.fromkeys(
                wrappers[n].launches_by_route, 0)
        sm.stream_matmul.h2d_bytes = 0
        mlayers.gather_rows.h2d_bytes = 0
        gather_param.h2d_bytes = 0
    return wrappers, routed, reset


def serve_record(plan, budget, params, pool) -> dict:
    """A serving cell's plan, the rank's parameter bytes by tier and its
    pool's global and local bytes by tier."""
    from repro_torch.core.offload import memory_kind_of
    from repro_torch.models.common import tree_leaves
    tiers = {}
    for leaf in tree_leaves(params):
        x = leaf.to_local()
        kind = memory_kind_of(x)
        tiers[kind] = tiers.get(kind, 0) + x.numel() * x.element_size()
    return {
        "plan": None if plan is None else {
            "hbm_budget": budget, "offloaded": list(plan.offloaded),
            "partial": [list(p) for p in plan.partial],
            "resident_bytes": plan.resident_bytes,
            "host_bytes": plan.host_bytes},
        "param_bytes_by_tier": tiers,
        "pool": {"device_bytes": pool.device_bytes,
                 "host_bytes": pool.host_bytes,
                 "local_device_bytes": pool.local_device_bytes,
                 "local_host_bytes": pool.local_host_bytes,
                 "split_leaves": pool.split_leaves,
                 "kinds": sorted(pool.memory_kinds())}}


def mesh_serve_cell(name: str, mesh_shape, rule: str) -> dict:
    """One serving cell of the mesh phase (``MESH_SERVE_CELLS``): the
    tenant added through ``SliceRuntime(mesh=...)`` under ``fake_world``,
    the kernels' launch counts set to 0 just before ``run`` and read just
    after, with the local shapes each kernel was launched at (the flash
    kernel's q, stream_matmul's x and w), each tick and prefill timed
    (synchronised), the bytes each tier holds and each link direction moved.
    The values on a fake world are undefined: only counts, shapes, bytes
    and times are read here."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import layers as mlayers
    from repro_torch.models.common import gather_param
    from repro_torch.serving import Request, SliceRuntime, TenantSpec
    cfg = get_config("llama3-8b").with_(attn_impl="pallas", remat="none",
                                        param_dtype="bfloat16")
    slots, max_seq = MESH_SERVE_SLOTS, MESH_SERVE_MAX_SEQ
    budget = spill_budget(cfg, slots, max_seq) if rule == "spill" else None
    wrappers, routed, reset_counts = serve_counters()
    shapes = {"flash_attention_fwd": set(), "stream_matmul": set()}
    flash, stream = kops.flash_attention, kops.stream_matmul

    def watched_flash(q, k, v, **kw):
        shapes["flash_attention_fwd"].add(tuple(q.shape))
        return flash(q, k, v, **kw)

    def watched_stream(x, w, **kw):
        shapes["stream_matmul"].add((tuple(x.shape), tuple(w.shape)))
        return stream(x, w, **kw)

    t_cell = time.time()
    with fake_world(mesh_shape[0] * mesh_shape[1]):
        mesh = make_host_mesh(*mesh_shape, device_type="cuda")
        torch.cuda.reset_peak_memory_stats()
        rt = SliceRuntime(mesh=mesh)
        t0 = time.time()
        tenant = rt.add_tenant(TenantSpec(
            "llm", cfg, profile="1s.16c", slots=slots, max_seq=max_seq,
            hbm_budget=budget, seed=SEED))
        torch.cuda.synchronize()
        add_s = time.time() - t0
        eng, plan = tenant.engine, tenant.plan
        pool = eng.pool
        rng = np.random.default_rng(SEED)
        reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(
                    np.int32), MESH_SERVE_NEW)
                for i, n in enumerate(MESH_SERVE_LENS)]
        prefill_s, tick_s, tick_link = [], [], []
        prefill, tick = eng.prefill, eng.tick

        def timed_prefill(req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = prefill(req)
            torch.cuda.synchronize()
            prefill_s.append((len(req.prompt), time.perf_counter() - t))
            return ok

        def timed_tick():
            n_pre, h2d, d2h = len(prefill_s), pool.h2d_bytes, pool.d2h_bytes
            streamed = sm.stream_matmul.h2d_bytes
            torch.cuda.synchronize()
            t = time.perf_counter()
            n = tick()
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t
                          - sum(s for _, s in prefill_s[n_pre:]))
            tick_link.append({"pool_h2d": pool.h2d_bytes - h2d,
                              "pool_d2h": pool.d2h_bytes - d2h,
                              "stream_matmul_h2d":
                                  sm.stream_matmul.h2d_bytes - streamed})
            return n

        eng.prefill, eng.tick = timed_prefill, timed_tick
        rt.submit("llm", reqs)
        reset_counts()                             # the main path starts here
        kops.flash_attention, kops.stream_matmul = watched_flash, watched_stream
        try:
            t0 = time.time()
            rt.run()
            torch.cuda.synchronize()
            run_s = time.time() - t0
        finally:
            kops.flash_attention, kops.stream_matmul = flash, stream
        rec = {
            "cell": name, "mesh": list(mesh_shape), "rank": 0,
            "world": mesh_shape[0] * mesh_shape[1],
            "card": torch.cuda.get_device_name(0),
            **serve_record(plan, budget, tenant.params, pool),
            "prefills": eng.stats.admitted, "ticks": eng.stats.ticks,
            "outputs": {str(k): v for k, v in eng.outputs.items()},
            "launches": {n: w.launches for n, w in wrappers.items()},
            "launches_by_route": {n: dict(wrappers[n].launches_by_route)
                                  for n in routed},
            "kernel_shapes": {n: sorted(v) for n, v in shapes.items()},
            "stream_matmul_h2d_bytes": sm.stream_matmul.h2d_bytes,
            "embed_rows_h2d_bytes": mlayers.gather_rows.h2d_bytes,
            "gather_param_h2d_bytes": gather_param.h2d_bytes,
            "tick_link_bytes": tick_link,
            "tick_ms": [1e3 * t for t in tick_s],
            "prefill_ms": [[n, 1e3 * t] for n, t in prefill_s],
            "add_tenant_s": add_s, "run_s": run_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del rt, tenant, eng, pool
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t_cell
    return rec


# the mesh phase's enc-dec serving cells: whisper-large-v3 at full width and
# depth (bf16, attn_impl "pallas") as one rank of a fake world, served as the
# encdec phase serves it on one device (TenantEngine feeds text tokens, A34):
# Model.forward(return_cache=True, last_token_only=True) -> a KVPool laid out
# by cache_specs_encdec -> paste -> ticks of materialize / Model.decode with
# one cache length a row / update. The encdec phase's 4 requests, 4 slots,
# max_seq 448, 8 new tokens each (the prefill's and 7 ticks'). "spill":
# rank 0 of (1, 4), 5 of 20 heads and 5 KV heads (Megatron), the self cache's
# positions [0, 112); the budget one byte under what spilling the tables and
# the pool frees, so decoder/w_in goes to the host tier too and the rank
# streams its pinned (32, 1280, 1280) shard on B2's ring, and the tied head
# its pinned token table. "resident": rank 4 of (1, 8) (8 does not divide 20
# heads: sequence-parallel attention), frames [752, 940), the self cache's
# positions [224, 280), every leaf on the card.
MESH_ENCDEC_CELLS = (("serve_whisper_1x4_spill", (1, 4), 0, "spill"),
                     ("serve_whisper_1x8", (1, 8), 4, "resident"))
MESH_ENCDEC_LENS, MESH_ENCDEC_NEW = (4, 16, 64, 224), 8
MESH_ENCDEC_SLOTS, MESH_ENCDEC_MAX_SEQ = 4, 448


def mesh_encdec_cell(name: str, mesh_shape, rank: int, rule: str) -> dict:
    """One enc-dec serving cell of the mesh phase (``MESH_ENCDEC_CELLS``)
    under ``fake_world``: the parameters drawn into the tiers the plan names,
    the kernels' launch counts set to 0 just before the first prefill and
    read just after the last tick, with the local shapes each kernel
    launched at (the flash kernel's q, k and query offset, stream_matmul's x
    and w), each prefill and tick timed (synchronised), the bytes each tier
    holds and each link direction moved. The values on a fake world are
    undefined: only counts, shapes, bytes and times are read here."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.offload import param_placement, plan_offload
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import layers as mlayers
    from repro_torch.models.common import is_dtensor, lay_local, pspec
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import KVPool
    cfg = get_config("whisper-large-v3").with_(attn_impl="pallas",
                                               remat="none",
                                               param_dtype="bfloat16")
    slots, max_seq = MESH_ENCDEC_SLOTS, MESH_ENCDEC_MAX_SEQ
    dev = torch.device("cuda")
    # the plan as SliceRuntime cuts it from the global inventory
    budget = plan = None
    if rule == "spill":
        budget = spill_budget(cfg, slots, max_seq)
        meta = build_model(cfg, "cuda")
        plan = plan_offload(meta.serving_inventory(
            meta.init(abstract=True)[0], meta.cache_shapes(slots, max_seq)),
            budget)
    wrappers, routed, reset_counts = serve_counters()
    shapes = {"flash_attention_fwd": set(), "stream_matmul": set()}
    flash, stream = kops.flash_attention, kops.stream_matmul

    def watched_flash(q, k, v, **kw):
        if q.shape[1]:          # an empty query block launches nothing
            shapes["flash_attention_fwd"].add(
                (tuple(q.shape), tuple(k.shape), int(kw.get("q_offset", 0))))
        return flash(q, k, v, **kw)

    def watched_stream(x, w, **kw):
        shapes["stream_matmul"].add((tuple(x.shape), tuple(w.shape)))
        return stream(x, w, **kw)

    t_cell = time.time()
    with fake_world(mesh_shape[0] * mesh_shape[1], rank):
        mesh = make_host_mesh(*mesh_shape, device_type="cuda")
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, mesh)
        env = model.env
        t0 = time.time()
        shapes_abs, _ = model.init(abstract=True)
        params, _ = model.init(
            torch.Generator(device=dev).manual_seed(SEED),
            placement=(None if plan is None
                       else param_placement(shapes_abs, plan, dev)))
        pool = KVPool(model, slots, max_seq, plan=plan)
        torch.cuda.synchronize()
        init_s = time.time() - t0

        def lay(batch, kind):
            """Every row, the same on every rank -> this rank's slice, laid
            out by the model's batch specs (a per-row pos over the tokens'
            batch axes)."""
            B, S = batch["tokens"].shape
            specs = model.batch_specs(ShapeSuite(kind, kind, S, B))
            spec = {k: specs[k][2] for k in batch if k in specs}
            spec["pos"] = pspec(specs["tokens"][2][0])
            return {k: lay_local(v, spec[k], env) for k, v in batch.items()}

        g = torch.Generator(device=dev).manual_seed(SEED + 5)
        rng = np.random.default_rng(SEED + 5)
        prompts = [{
            "frames": (0.02 * torch.randn(1, cfg.encoder_seq, cfg.d_model,
                                          generator=g, device=dev)
                       ).to(torch.bfloat16),
            "tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   size=(1, n)), device=dev)}
            for n in MESH_ENCDEC_LENS]
        full = lambda t: t.full_tensor() if is_dtensor(t) else t
        prefill_s, tick_s, tick_link, out, rows = [], [], [], {}, {}
        reset_counts()                             # the main path starts here
        kops.flash_attention, kops.stream_matmul = watched_flash, watched_stream
        try:
            for rid, batch in enumerate(prompts):
                torch.cuda.synchronize()
                t = time.perf_counter()
                logits, _, pc = model.forward(params, lay(batch, "prefill"),
                                              return_cache=True,
                                              last_token_only=True)
                slot = pool.alloc_slot()
                plen = batch["tokens"].shape[1]
                pool.paste(slot, pc, plen)
                out[rid] = [int(full(logits)[0, -1].argmax())]
                rows[slot] = rid
                torch.cuda.synchronize()
                prefill_s.append((plen, time.perf_counter() - t))
            for _ in range(MESH_ENCDEC_NEW - 1):
                h2d, d2h = pool.h2d_bytes, pool.d2h_bytes
                streamed = sm.stream_matmul.h2d_bytes
                torch.cuda.synchronize()
                t = time.perf_counter()
                last = torch.tensor([[out[rows[s]][-1]] for s in range(slots)],
                                    device=dev)
                pos = torch.as_tensor(pool.positions.astype(np.int64),
                                      device=dev)
                logits, cache = model.decode(
                    params, pool.materialize(),
                    lay({"tokens": last, "pos": pos}, "decode"))
                pool.update(cache)
                nxt = full(logits).argmax(-1).tolist()
                for s in range(slots):
                    out[rows[s]].append(nxt[s])
                pool.positions += 1
                torch.cuda.synchronize()
                tick_s.append(time.perf_counter() - t)
                tick_link.append({
                    "pool_h2d": pool.h2d_bytes - h2d,
                    "pool_d2h": pool.d2h_bytes - d2h,
                    "stream_matmul_h2d": sm.stream_matmul.h2d_bytes - streamed})
        finally:
            kops.flash_attention, kops.stream_matmul = flash, stream
        rec = {
            "cell": name, "arch": cfg.name, "mesh": list(mesh_shape),
            "rank": rank, "world": mesh_shape[0] * mesh_shape[1],
            "coords": {a: mesh.get_local_rank(a) for a in env.mesh_axes},
            "card": torch.cuda.get_device_name(0),
            "policy": dict(model.pol.__dict__),
            **serve_record(plan, budget, params, pool),
            "prefills": len(prefill_s), "ticks": len(tick_s),
            "outputs": {str(k): v for k, v in out.items()},
            "launches": {n: w.launches for n, w in wrappers.items()},
            "launches_by_route": {n: dict(wrappers[n].launches_by_route)
                                  for n in routed},
            "kernel_shapes": {n: sorted(v) for n, v in shapes.items()},
            "stream_matmul_h2d_bytes": sm.stream_matmul.h2d_bytes,
            "embed_rows_h2d_bytes": mlayers.gather_rows.h2d_bytes,
            "tick_link_bytes": tick_link,
            "tick_ms": [1e3 * t for t in tick_s],
            "prefill_ms": [[n, 1e3 * t] for n, t in prefill_s],
            "init_s": init_s,
            "max_memory_allocated": torch.cuda.max_memory_allocated()}
        del model, params, pool, prompts
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"] = time.time() - t_cell
    return rec


def mesh_child(out_dir: str) -> None:
    """The mesh phase's child process: each cell of ``MESH_CELLS`` through
    ``launch/dryrun.py`` as its rank of a fake world (the fake process group
    lives and dies in this process, away from the other phases). The flash,
    grouped_matmul and ssd_scan wrappers' launch counts are set to 0 just
    before each cell and read just after; their ``kernel_cost`` is watched
    to record the shapes each kernel was launched at in the counted pass
    (flash: q's, k's and the query offset; grouped_matmul: x's, w's and
    whether x is one buffer shared by the experts; ssd_scan: x's and B's).
    Writes ``mesh.json``."""
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.launch import dryrun
    _build.build_all()
    wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
                "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
                "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                "grouped_matmul": gmm.grouped_matmul,
                "ssd_scan": ssd.ssd_scan}
    shapes = {}
    cost, gmm_cost, ssd_cost = fa.kernel_cost, gmm.kernel_cost, ssd.kernel_cost

    def watched(name, q, k, causal, q_offset=0):
        shapes.setdefault(name, set()).add(
            (tuple(q.shape), tuple(k.shape), q_offset))
        return cost(name, q, k, causal, q_offset)

    def watched_gmm(x, w, on_host):
        shapes.setdefault("grouped_matmul", set()).add(
            (tuple(x.shape), tuple(w.shape), x.stride(0) == 0))
        return gmm_cost(x, w, on_host)
    def watched_ssd(x, B_, with_init, with_state):
        shapes.setdefault("ssd_scan", set()).add(
            (tuple(x.shape), tuple(B_.shape)))
        return ssd_cost(x, B_, with_init, with_state)
    fa.kernel_cost, gmm.kernel_cost = watched, watched_gmm
    ssd.kernel_cost = watched_ssd
    routed = {n: w for n, w in wrappers.items() if n != "ssd_scan"}
    cells = []
    for arch, shape, mesh, over, rank, iters in MESH_CELLS:
        for w in wrappers.values():
            w.launches = 0
        for w in routed.values():
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)
        shapes.clear()
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape, os.path.join(out_dir, mesh),
                              device="cuda", mesh=mesh, rank=rank,
                              iters=iters, overrides=dict(over) or None)
        seconds = time.time() - t0
        cells.append({
            "arch": arch, "shape": shape, "mesh_kind": mesh, "record": rec,
            "seconds": seconds,
            "launches": {n: w.launches for n, w in wrappers.items()},
            "launches_by_route": {n: dict(w.launches_by_route)
                                  for n, w in routed.items()},
            "kernel_shapes": {n: sorted(v) for n, v in shapes.items()}})
        torch.cuda.empty_cache()
    fa.kernel_cost, gmm.kernel_cost, ssd.kernel_cost = cost, gmm_cost, ssd_cost
    serve = [mesh_serve_cell(*cell) for cell in MESH_SERVE_CELLS]
    serve_encdec = [mesh_encdec_cell(*cell) for cell in MESH_ENCDEC_CELLS]
    with open(os.path.join(out_dir, "mesh.json"), "w") as f:
        json.dump({"cells": cells, "serve": serve,
                   "serve_encdec": serve_encdec}, f)


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "src"))
    if sys.argv[1:2] == ["--mesh-child"]:
        mesh_child(sys.argv[2])
        return
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.offload import (empty_host, memory_kind_of,
                                          param_placement, place_tree,
                                          plan_offload, to_host)
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import grouped_matmul as gmm
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import ssd_scan as ssd
    from repro_torch.kernels import stream_matmul as sm
    from repro_torch.data.pipeline import DataPipeline, SyntheticSource, to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch.profile_serve import device_summary
    from repro_torch.launch.train import build_config, train as run_training
    from repro_torch.core.offload import _flatten_with_paths
    from repro_torch.models import encdec as mencdec
    from repro_torch.models import layers as mlayers
    from repro_torch.models import moe as mmoe
    from repro_torch.models import ssm as mssm
    from repro_torch.models import transformer as mtfm
    from repro_torch.models.common import tree_leaves
    from repro_torch.models.model_zoo import build_model
    from repro_torch.serving import (KVPool, Request, ServingEngine,
                                     SliceRuntime, TenantEngine, TenantSpec)
    from repro_torch.train.train_step import _accumulate_grads

    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references in fp32
    dev = torch.device("cuda")
    kernel_wrappers = {"flash_attention_fwd": fa.flash_attention_fwd,
                       "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
                       "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
                       "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
                       "stream_matmul": sm.stream_matmul,
                       "ssd_scan": ssd.ssd_scan,
                       "grouped_matmul": gmm.grouped_matmul}

    # the wrappers that count their launches by kernel route as well
    routed = {"flash_attention_fwd": fa.flash_attention_fwd,
              "flash_attention_fwd_stats": fa.flash_attention_fwd_stats,
              "flash_attention_bwd_dkdv": fa.flash_attention_bwd_dkdv,
              "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
              "grouped_matmul": gmm.grouped_matmul}

    def reset_counts():
        for w in kernel_wrappers.values():
            w.launches = 0
        for w in routed.values():
            w.launches_by_route = dict.fromkeys(w.launches_by_route, 0)
        sm.stream_matmul.launches_by_route = dict.fromkeys(sm.ROUTES, 0)
        sm.stream_matmul.h2d_bytes = 0
        gmm.grouped_matmul.h2d_bytes = 0
        gmm.grouped_matmul.transpose_bytes = 0
        mlayers.gather_rows.h2d_bytes = 0
        mtfm.offload_activation.d2h_bytes = 0

    # ------------------------------------------------------------------ env
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card_line = smi.stdout.strip().splitlines()[0].strip()
    # the training phases' final checkpoints go to the temporary directory
    # (train_phi3's: ~46 GB of parameters and moments)
    tmp_disk = shutil.disk_usage(tempfile.gettempdir())
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), card=card_line,
         host_memory=host_memory(), tmp_dir=tempfile.gettempdir(),
         tmp_free_bytes=tmp_disk.free, tmp_total_bytes=tmp_disk.total)

    # ---------------------------------------------------------------- build
    t0 = time.time()
    libs = _build.build_all()
    for name in libs:
        _build.load(name)
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in _build.build_log.items()}
    spills = sorted({ln for lines in ptxas.values() for ln in lines
                     if "spill" in ln and "0 bytes spill stores, 0 bytes spill loads" not in ln})
    regs = sorted({int(ln.split("Used ")[1].split(" registers")[0])
                   for lines in ptxas.values() for ln in lines if "Used " in ln})
    # ptxas's C7510-C7519 notes: a wgmma it had to serialize
    serialized = sorted({ln.strip() for log in _build.build_log.values()
                         for ln in log.splitlines() if "(C751" in ln})
    emit("build", seconds=round(time.time() - t0, 2), libraries=sorted(libs),
         nvcc=_build.find_nvcc(), registers=regs, spilling=spills[:8],
         wgmma_serialized=serialized)
    if spills:
        fail(f"ptxas reports register spills: {spills[:4]}")


    # -------------------------------------------------------------- kernels
    flush_buf = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def route_counts():
        return {n: dict(w.launches_by_route) for n, w in routed.items()}

    def check_launches(phase, got, want):
        if got != want:
            fail(f"{phase}: launches {got} != expected {want}")

    def planned_stream_routes(engine, per_pass):
        """stream_matmul's launches by route that stream_matmul.plan gives a
        run of ``engine`` whose streamed weights are pinned: ``per_pass``
        calls in each prefill and each tick, all on the ring."""
        n = (len(engine.prefill_s) + engine.stats.ticks) * per_pass
        return {"ring": n, "resident": 0}

    def time_ms(fn, warmup=3, iters=20, cold=False):
        """Median ms of one call between CUDA events; ``cold`` writes
        ``flush_buf`` (256 MB, five times the L2) before each call, outside
        the events."""
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if cold:
                flush_buf.fill_(1)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(nbytes, flops, dtype_name):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")

    def lower_right(Sq, Sk, q_offset):
        """SDPA's mask for the same function: the causal mask aligned to
        the bottom right (a query block at the end of its keys), or None
        for the plain (top-left) causal mask."""
        if not q_offset:
            return None
        if Sq + q_offset != Sk:
            fail(f"no library mask for {Sq} queries at offset {q_offset} over "
                 f"{Sk} keys")
        from torch.nn.attention.bias import causal_lower_right
        return causal_lower_right(Sq, Sk)

    def flash_case(BH, S, hd, dtype_name, causal, Sk=None, q_offset=0):
        """B1 at q (BH, S, hd) and k, v (BH, Sk, hd) (Sk = S by default),
        causal at ``q_offset``."""
        dtype = getattr(torch, dtype_name)
        Sk = S if Sk is None else Sk
        g = torch.Generator(device=dev).manual_seed(SEED + S + hd + q_offset)
        q = torch.randn(BH, S, hd, device=dev, generator=g).to(dtype)
        k, v = (torch.randn(BH, Sk, hd, device=dev, generator=g).to(dtype)
                for _ in range(2))
        call = lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                              q_offset=q_offset)
        got = call()
        want = fa.flash_attention_fwd_plain(q, k, v, causal=causal,
                                            q_offset=q_offset)
        torch.cuda.synchronize()
        shape = [BH, S, hd] if Sk == S else [BH, S, Sk, hd]
        if not torch.isfinite(got.float()).all():
            fail(f"flash_attention_fwd gave non-finite values at {shape}")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        if rel >= TOL[dtype_name]:
            fail(f"flash_attention_fwd disagrees with its plain version at "
                 f"{shape} {dtype_name} causal={causal} q_offset={q_offset}: "
                 f"rel {rel:.3e} >= {TOL[dtype_name]}")
        q4, k4, v4 = (t[None] for t in (q, k, v))
        if causal and q_offset and S + q_offset < Sk:
            # a block of queries whose last position lies before the last
            # key: the keys past it are masked, so the library attends the
            # keys the block sees, the same function
            k4, v4 = k4[:, :, :S + q_offset], v4[:, :, :S + q_offset]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        mask = lower_right(S, k4.shape[2], q_offset) if causal else None
        library = (lambda: sdpa(q4, k4, v4, attn_mask=mask)) if mask is not None \
            else (lambda: sdpa(q4, k4, v4, is_causal=causal))
        flops = 4.0 * BH * fa.attended_pairs(S, Sk, causal, q_offset) * hd
        bound_ms, bound_by = bound(2.0 * BH * (S + Sk) * hd * q.element_size(),
                                   flops, dtype_name)
        ms = time_ms(call)
        row = {
            "shape": shape, "dtype": dtype_name, "causal": causal,
            "route": fa.FWD_ROUTES[dtype],
            "max_abs_err": abs_err, "rel_err": rel, "tol": TOL[dtype_name],
            "ms": ms,
            "cold_ms": time_ms(call, cold=True),
            "plain_ms": time_ms(lambda: fa.flash_attention_fwd_plain(
                q, k, v, causal=causal, q_offset=q_offset), iters=5),
            "library_ms": time_ms(library),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tflops": flops / (ms * 1e-3) / 1e12,
        }
        if q_offset:
            lib = library()[0]
            row.update(q_offset=q_offset, library="sdpa, causal_lower_right",
                       library_rel_err=float((lib.float() - want.float()).abs().max())
                       / (float(want.float().abs().max()) + 1e-9))
        return row

    cases = [flash_case(32, 1024, 128, "bfloat16", True),   # the headline
             flash_case(32, 128, 128, "bfloat16", True),
             flash_case(32, 300, 128, "bfloat16", True),    # ragged S
             flash_case(32, 1024, 128, "float32", True),
             flash_case(32, 128, 128, "float32", True),
             flash_case(32, 300, 128, "float32", True),
             flash_case(32, 256, 128, "float32", False),
             flash_case(12, 300, 64, "bfloat16", True),     # gpt2's head dim
             flash_case(20, 224, 64, "bfloat16", True),     # whisper's decoder prefill
             flash_case(64, 1048, 128, "bfloat16", True)]   # qwen2-vl's prefill
    encdec_case, vlm_case = cases[-2], cases[-1]
    hd96_cases = [flash_case(32, 1024, 96, "bfloat16", True),  # phi3-mini's head dim
                  flash_case(32, 1024, 96, "float32", True)]
    # the cluster phase's prefills: one request of 4-8 tokens, heads after
    # expand_kv, so a single ragged tile (gpt2, phi3-mini, llama3-8b, qwen3-32b)
    cluster_cases = [flash_case(BH, S, hd, "bfloat16", True)
                     for BH, hd in ((12, 64), (32, 96), (32, 128), (64, 128))
                     for S in (4, 8)]
    cases += hd96_cases + cluster_cases
    # the dryrun phase's llama3-8b prefill_32k: rows of 32,768 tokens (two
    # heads here, so that the plain version's scores fit)
    long_flash_case = flash_case(2, 32768, 128, "bfloat16", True)
    cases.append(long_flash_case)
    # serve_starcoder2's and serve_command_r's 1,024-token prefills: 36 and
    # 64 query heads after expand_kv (GQA groups of 9 and 8)
    full_arch_cases = [flash_case(36, 1024, 128, "bfloat16", True),
                       flash_case(64, 1024, 128, "bfloat16", True)]
    cases += full_arch_cases

    def flash_train_case(BH, S, hd, dtype_name, causal, Sk=None, q_offset=0):
        """The forward with lse and the two backward kernels against their
        plain versions; the backward kernels and their plain versions get the
        same (plain) lse and delta, so each is held alone. q and dO (BH, S,
        hd), k and v (BH, Sk, hd) (Sk = S by default), causal at
        ``q_offset``."""
        dtype = getattr(torch, dtype_name)
        Sk = S if Sk is None else Sk
        g = torch.Generator(device=dev).manual_seed(SEED + 7 * S + hd + q_offset)
        q, k, v, do = (torch.randn(BH, n, hd, device=dev, generator=g).to(dtype)
                       for n in (S, Sk, Sk, S))
        shape = [BH, S, hd] if Sk == S else [BH, S, Sk, hd]
        off = {"q_offset": q_offset}
        scale = hd ** -0.5
        want_routes = {"flash_attention_fwd_stats": [fa.FWD_ROUTES[dtype]],
                       "flash_attention_bwd_dkdv": [fa.BWD_ROUTES[dtype]],
                       "flash_attention_bwd_dq": [fa.BWD_ROUTES[dtype]]}
        routes_before = {n: dict(routed[n].launches_by_route) for n in want_routes}
        out, lse = fa.flash_attention_fwd_stats(q, k, v, causal=causal, **off)
        p_out, p_lse = fa.flash_attention_fwd_stats_plain(q, k, v, causal=causal,
                                                          **off)
        delta = fa.bwd_delta(p_out, do)
        bwd_args = (q, k, v, do, p_lse, delta)
        dk, dv = fa.flash_attention_bwd_dkdv(*bwd_args, causal=causal, **off)
        dq = fa.flash_attention_bwd_dq(*bwd_args, causal=causal, **off)
        launched_routes = {
            n: sorted(r for r, c in routed[n].launches_by_route.items()
                      if c != routes_before[n][r]) for n in want_routes}
        if launched_routes != want_routes:
            fail(f"flash training kernels at {shape} {dtype_name} took "
                 f"{launched_routes}, not {want_routes}")
        p_dk, p_dv = fa.flash_attention_bwd_dkdv_plain(*bwd_args, causal=causal,
                                                       **off)
        p_dq = fa.flash_attention_bwd_dq_plain(*bwd_args, causal=causal, **off)
        torch.cuda.synchronize()
        tol = TRAIN_TOL[dtype_name]
        errors = {}
        for name, got, want, t in (
                ("out", out, p_out, tol["out"]), ("lse", lse, p_lse, tol["lse"]),
                ("dq", dq, p_dq, tol["grad"]), ("dk", dk, p_dk, tol["grad"]),
                ("dv", dv, p_dv, tol["grad"])):
            if not torch.isfinite(got.float()).all():
                fail(f"{name} of the flash training kernels is not finite at "
                     f"{shape} {dtype_name}")
            abs_err = float((got.float() - want.float()).abs().max())
            rel = abs_err / (float(want.float().abs().max()) + 1e-9)
            if rel >= t:
                fail(f"flash training kernels: {name} disagrees with its plain "
                     f"version at {shape} {dtype_name} causal={causal} "
                     f"q_offset={q_offset}: rel {rel:.3e} >= {t}")
            errors[name] = {"max_abs_err": abs_err, "rel_err": rel, "tol": t}
        # bounds: each input read once, each output written once; one
        # product is 2*BH*pairs*hd operations
        pairs = fa.attended_pairs(S, Sk, causal, q_offset)
        prod = 2.0 * BH * pairs * hd
        tile = BH * S * hd * q.element_size()          # q, dO, o, dq
        ktile = BH * Sk * hd * q.element_size()        # k, v, dk, dv
        stats = BH * S * 4
        fwd_b = bound(2 * tile + 2 * ktile + stats, 2 * prod, dtype_name)  # q k v -> o, lse
        dkdv_b = bound(2 * tile + 4 * ktile + 2 * stats, 4 * prod,
                       dtype_name)                                  # S, dV, dP, dK
        dq_b = bound(3 * tile + 2 * ktile + 2 * stats, 3 * prod,
                     dtype_name)                                    # S, dP, dQ
        bwd_b = bound(4 * tile + 4 * ktile + stats, 5 * prod,
                      dtype_name)                                   # the function
        # the library: PyTorch's flash kernels for bf16, its memory-efficient
        # ones for fp32 (flash takes no fp32); the backward as its one aten op
        q4, k4, v4, do4 = (t[None] for t in (q, k, v, do))
        aten = torch.ops.aten
        sdpa = torch.nn.functional.scaled_dot_product_attention
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q4, k4, v4))
        mask = lower_right(S, Sk, q_offset) if causal else None
        if mask is not None:
            # a block of queries at its offset: SDPA with the bottom-right
            # causal mask, forward alone and the backward through autograd
            lib_fwd = lambda: sdpa(q4, k4, v4, attn_mask=mask, scale=scale)
            lib_out = sdpa(ql, kl, vl, attn_mask=mask, scale=scale)
            lib_bwd = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do4,
                                                  retain_graph=True)
        elif dtype == torch.bfloat16:
            lib_fwd = lambda: aten._scaled_dot_product_flash_attention(
                q4, k4, v4, 0.0, causal, False, scale=scale)
            o, l, cq, ck, mq, mk, seed, offset = lib_fwd()[:8]
            lib_bwd = lambda: aten._scaled_dot_product_flash_attention_backward(
                do4, q4, k4, v4, o, l, cq, ck, mq, mk, 0.0, causal, seed, offset,
                scale=scale)
        else:
            lib_fwd = lambda: aten._scaled_dot_product_efficient_attention(
                q4, k4, v4, None, True, 0.0, causal, scale=scale)
            o, l, seed, offset = lib_fwd()
            lib_bwd = lambda: aten._scaled_dot_product_efficient_attention_backward(
                do4, q4, k4, v4, None, o, l, seed, offset, 0.0,
                [True, True, True, False], causal, scale=scale)
        if mask is None:
            lib_out = sdpa(ql, kl, vl, is_causal=causal, scale=scale)
        row = {
            "shape": shape, "dtype": dtype_name, "causal": causal,
            "errors": errors, "launched_routes": launched_routes,
            "fwd_stats_route": fa.FWD_ROUTES[dtype],
            "fwd_stats_ms": time_ms(lambda: fa.flash_attention_fwd_stats(
                q, k, v, causal=causal, **off)),
            "fwd_stats_cold_ms": time_ms(lambda: fa.flash_attention_fwd_stats(
                q, k, v, causal=causal, **off), cold=True),
            "fwd_stats_plain_ms": time_ms(lambda: fa.flash_attention_fwd_stats_plain(
                q, k, v, causal=causal, **off), iters=5),
            "fwd_stats_library_ms": time_ms(lib_fwd),
            "fwd_stats_bound_ms": fwd_b[0], "fwd_stats_bound_by": fwd_b[1],
            "bwd_route": fa.BWD_ROUTES[dtype],
            "delta_ms": time_ms(lambda: fa.bwd_delta(p_out, do)),
            "dkdv_ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(
                *bwd_args, causal=causal, **off)),
            "dkdv_cold_ms": time_ms(lambda: fa.flash_attention_bwd_dkdv(
                *bwd_args, causal=causal, **off), cold=True),
            "dkdv_plain_ms": time_ms(lambda: fa.flash_attention_bwd_dkdv_plain(
                *bwd_args, causal=causal, **off), iters=5),
            "dkdv_bound_ms": dkdv_b[0], "dkdv_bound_by": dkdv_b[1],
            "dq_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
                *bwd_args, causal=causal, **off)),
            "dq_cold_ms": time_ms(lambda: fa.flash_attention_bwd_dq(
                *bwd_args, causal=causal, **off), cold=True),
            "dq_plain_ms": time_ms(lambda: fa.flash_attention_bwd_dq_plain(
                *bwd_args, causal=causal, **off), iters=5),
            "dq_bound_ms": dq_b[0], "dq_bound_by": dq_b[1],
            # the library's whole backward (dq, dk, dv in one call), and the
            # same through autograd, whose host work adds to the timed span
            "bwd_library_ms": time_ms(lib_bwd),
            # like for like with it: one call of the port's whole backward,
            # delta then dk/dv then dq
            "bwd_total_ms": time_ms(lambda: fa.flash_attention_bwd(
                q, k, v, p_out, p_lse, do, causal=causal, **off)),
            "bwd_library_autograd_ms": time_ms(lambda: torch.autograd.grad(
                lib_out, (ql, kl, vl), do4, retain_graph=True)),
            "bwd_bound_ms": bwd_b[0], "bwd_bound_by": bwd_b[1],
        }
        if mask is not None:
            row.update(q_offset=q_offset, library="sdpa, causal_lower_right "
                       "(the backward through autograd)",
                       library_rel_err=float((lib_out[0].detach().float()
                                              - p_out.float()).abs().max())
                       / (float(p_out.float().abs().max()) + 1e-9))
        row["bwd_ms"] = row["dkdv_ms"] + row["dq_ms"]
        return row

    train_cases = [flash_train_case(96, 1024, 64, "bfloat16", True),   # gpt2 training
                   flash_train_case(32, 2048, 128, "bfloat16", True),  # llama3-8b heads
                   flash_train_case(32, 1024, 128, "bfloat16", True),  # serving's shape
                   flash_train_case(4, 256, 64, "float32", True),      # the reference's
                   flash_train_case(4, 256, 64, "float32", False),
                   flash_train_case(12, 1000, 64, "bfloat16", True)]   # ragged S
    hd96_train_cases = [flash_train_case(32, 1024, 96, "bfloat16", True),  # phi3-mini
                        flash_train_case(32, 1024, 96, "float32", True)]
    train_cases += hd96_train_cases
    # train_phi3's shape: T_BATCH sequences x 32 heads of T_SEQ tokens
    phi3_train_case = flash_train_case(T_BATCH * 32, T_SEQ, 96, "bfloat16",
                                       True)
    train_cases.append(phi3_train_case)

    def host_us(fn, calls=200):
        """Host time of one wrapper call, µs: ``calls`` calls issued back to
        back, the clock stopped before the card catches up."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        t = time.perf_counter() - t
        torch.cuda.synchronize()
        return t / calls * 1e6

    def rel_err(a, b):
        return float((a.float() - b.float()).abs().max()
                     / (b.float().abs().max() + 1e-9))

    # the host link's rate: one 1 GiB pinned -> device copy between events,
    # from the host tier's own buffers (core.offload.empty_host: pages
    # registered with CUDA) and, beside it, from the caching host
    # allocator's (pin_memory=True)
    dev_buf = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    host_buf = empty_host((1 << 30,), torch.uint8, dev)
    link_ms = time_ms(lambda: dev_buf.copy_(host_buf, non_blocking=True),
                      warmup=1, iters=5)
    host_buf = torch.empty(1 << 30, dtype=torch.uint8, pin_memory=True)
    link_alloc_ms = time_ms(lambda: dev_buf.copy_(host_buf, non_blocking=True),
                            warmup=1, iters=5)
    link_bytes_per_s = (1 << 30) / (link_ms * 1e-3)
    link_alloc_bytes_per_s = (1 << 30) / (link_alloc_ms * 1e-3)
    del host_buf, dev_buf
    # a bound is never above what was reached
    link_bound_rate = max(HOST_LINK_BYTES_PER_S, link_bytes_per_s)

    def stream_plan(x, w, where):
        return sm.plan(x.shape[0], x.shape[1], w.shape[1], x.dtype, w.dtype,
                       bool(sm._w_layout(w)[0]), where)

    def stream_case(M, K, N, xdt, wdt, where, transposed=False):
        """x (M, K) on the card; w (K, N) on the card or in pinned host
        memory (a host-tier buffer, ``to_host``, as the main path places
        it), or the transposed view of an (N, K) table. A pinned case's
        rate is given as a share of the 1 GiB pinned copy's (``link_share``
        for the kernel alone, cold; ``link_share_idle`` from an idle card)."""
        g = torch.Generator(device=dev).manual_seed(SEED + M + K + N)
        x = torch.randn(M, K, device=dev, generator=g).to(getattr(torch, xdt))
        shape = (N, K) if transposed else (K, N)
        w_dev = (torch.randn(*shape, device=dev, generator=g)
                 * K ** -0.5).to(getattr(torch, wdt))
        w = w_dev if where == "device" else to_host(w_dev, dev)
        if transposed:
            w_dev, w = w_dev.T, w.T
        before = sm.stream_matmul.h2d_bytes
        routes = dict(sm.stream_matmul.launches_by_route)
        got = sm.stream_matmul(x, w)
        h2d = sm.stream_matmul.h2d_bytes - before
        route = [r for r, n in sm.stream_matmul.launches_by_route.items()
                 if n != routes[r]]
        if route != [stream_plan(x, w, where).route]:
            fail(f"stream_matmul took {route} at {(M, K, N)}, not its plan's "
                 f"{stream_plan(x, w, where)}")
        want = sm.stream_matmul_plain(x, w_dev)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"stream_matmul gave non-finite values at {(M, K, N)}")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        tol = STREAM_TOL[xdt]
        if rel >= tol:
            fail(f"stream_matmul disagrees with its plain version at "
                 f"{(M, K, N)} x {xdt} w {wdt} {where}: rel {rel:.3e} >= {tol}")
        w_bytes = K * N * w.element_size()
        if h2d != (w_bytes if where == "pinned" else 0):
            fail(f"stream_matmul streamed {h2d} bytes for a {where} w of "
                 f"{w_bytes} bytes")
        nbytes = (M * K + M * N) * x.element_size() + w_bytes
        flops = 2.0 * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[xdt] * 1e3
        t_link = w_bytes / link_bound_rate * 1e3 if where == "pinned" else 0.0
        ms = time_ms(lambda: sm.stream_matmul(x, w))
        cold = time_ms(lambda: sm.stream_matmul(x, w), cold=True)
        lib_dev = time_ms(lambda: x @ w_dev.to(x.dtype))
        lib_host = (time_ms(lambda: x @ w.to(dev, non_blocking=True).to(x.dtype))
                    if where == "pinned" else None)
        link = lambda t: w_bytes / (t * 1e-3) / link_bytes_per_s
        return {
            "shape": [M, K, N], "x": xdt, "w": wdt, "where": where,
            "transposed": transposed, "route": route[0],
            "plan": stream_plan(x, w, where)._asdict(),
            "max_abs_err": abs_err, "rel_err": rel,
            "tol": tol, "kernel_ms": ms, "cold_ms": cold,
            "link_share": link(cold) if where == "pinned" else None,
            "link_share_idle": link(ms) if where == "pinned" else None,
            "wrapper_host_us": host_us(lambda: sm.stream_matmul(x, w), calls=20),
            "plain_ms": time_ms(lambda: sm.stream_matmul_plain(x, w_dev), iters=5),
            "library_ms": lib_host if lib_host is not None else lib_dev,
            "library_device_w_ms": lib_dev, "library_host_w_ms": lib_host,
            "bound_ms": max(t_bytes, t_ops, t_link),
            "bound_by": "bytes" if max(t_bytes, t_link) >= t_ops else "operations",
            "h2d_bytes": h2d,
            "h2d_gb_per_s": h2d / (ms * 1e-3) / 1e9 if h2d else None,
        }

    # routes by stream_matmul.plan: a pinned w -> ring, a device w -> resident
    stream_cases = [
        stream_case(4, 4096, 14336, "bfloat16", "bfloat16", "pinned"),  # decode
        stream_case(1024, 4096, 14336, "bfloat16", "bfloat16", "pinned"),
        stream_case(4, 14336, 4096, "bfloat16", "bfloat16", "pinned"),  # w_out-like
        stream_case(5, 4096, 1000, "bfloat16", "bfloat16", "pinned"),   # ragged
        stream_case(4, 1024, 49155, "bfloat16", "bfloat16", "pinned",
                    transposed=True),                    # granite's tied unembed
        stream_case(4, 768, 50257, "bfloat16", "float32", "pinned",
                    transposed=True),                    # gpt2's tied unembed
        stream_case(4, 4096, 4096, "bfloat16", "float32", "pinned"),
        stream_case(128, 512, 128, "float32", "float32", "device"),  # reference
        stream_case(256, 1024, 384, "float32", "float32", "device"),
        stream_case(4, 4096, 14336, "bfloat16", "bfloat16", "device"),
        stream_case(1024, 4096, 14336, "bfloat16", "bfloat16", "device"),
    ]
    # the vlm phase's streamed stacks: one layer of qwen2-vl-72b's w_in or
    # w_gate (484 MB), at a 4-slot decode tick and at its longest prefill
    vlm_stream_cases = [
        stream_case(4, 8192, 29568, "bfloat16", "bfloat16", "pinned"),
        stream_case(1048, 8192, 29568, "bfloat16", "bfloat16", "pinned")]
    stream_cases += vlm_stream_cases

    def ring_depths(M, K, N):
        """The ring at several panel depths (``block_k`` rows; "plan": the
        byte-sized panels the plan picks), ms from an idle card and cold ms,
        beside the library's one copy and product, so the depth the plan
        uses can be checked against the others on this card."""
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(M, K, device=dev, generator=g).to(torch.bfloat16)
        w = to_host((torch.randn(K, N, device=dev, generator=g)
                     * K ** -0.5).to(torch.bfloat16), dev)
        out = {"shape": [M, K, N],
               "plan_rows": sm.panel_rows(K, N, w.element_size()),
               "library_host_w_ms": time_ms(lambda: x @ w.to(dev, non_blocking=True)),
               "ms": {}, "cold_ms": {}}
        for bk in (512, 1024, 2048, 4096, None):
            key = bk or "plan"
            run = lambda: sm.stream_matmul(x, w, block_k=bk)
            out["ms"][key] = time_ms(run)
            out["cold_ms"][key] = time_ms(run, cold=True)
        return out

    stream_ring_depths = [ring_depths(4, 4096, 14336), ring_depths(4, 14336, 4096),
                          ring_depths(1024, 4096, 14336)]

    def ssd_case(B, S, nh, hp, N, dtype_name, with_state=False):
        """y and the final state of the SSD kernel against its plain version.
        Bound: x, dt, A, B_, C_ (and an initial state) read once, y and the
        final state written once; the chunked algorithm's operations at the
        kernels' chunk, counted for the rows this S has: C B^T once per
        (batch, chunk), the decay-weighted intra-chunk product and the
        carried-state and state-update products per head. ``bound_ms``: all
        of them at the peak rate of the input type (bf16 on the tensor
        cores, fp32 on the CUDA cores), against bytes. ``bound_fma_ms``: the
        earlier mixed-unit figure, C B^T at the bf16 rate and the rest at
        fp32 FMA's."""
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(SEED + S + nh + N)
        x = (0.5 * torch.randn(B, S, nh, hp, device=dev, generator=g)).to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn(B, S, nh, device=dev, generator=g))
        A = -torch.exp(0.3 * torch.randn(nh, device=dev, generator=g))
        Bm, Cm = ((0.3 * torch.randn(B, S, N, device=dev, generator=g)).to(dtype)
                  for _ in range(2))
        s0 = (0.5 * torch.randn(B, nh, hp, N, device=dev, generator=g)
              if with_state else None)
        run = lambda: ssd.ssd_scan(x, dt, A, Bm, Cm, init_state=s0,
                                   return_state=True)
        plain = lambda: ssd.ssd_scan_plain(x, dt, A, Bm, Cm, init_state=s0,
                                           return_state=True)
        y, st = run()
        py, pst = plain()
        torch.cuda.synchronize()
        if not (torch.isfinite(y.float()).all() and torch.isfinite(st).all()):
            fail(f"ssd_scan gave non-finite values at {(B, S, nh, hp, N)}")
        abs_err = float((y.float() - py.float()).abs().max())
        rel = abs_err / (float(py.float().abs().max()) + 1e-9)
        state_rel = rel_err(st, pst)
        if rel >= SSD_TOL[dtype_name] or state_rel >= SSD_STATE_TOL:
            fail(f"ssd_scan disagrees with its plain version at "
                 f"{(B, S, nh, hp, N)} {dtype_name} init_state={with_state}: "
                 f"y rel {rel:.3e} (limit {SSD_TOL[dtype_name]}), state rel "
                 f"{state_rel:.3e} (limit {SSD_STATE_TOL})")
        Q = ssd.CHUNK
        pairs = sum(v * (v + 1) // 2
                    for v in (min(Q, S - c) for c in range(0, S, Q)))
        g_flops = 2.0 * B * pairs * N
        rest_flops = 2.0 * B * nh * (pairs * hp + 2 * S * hp * N)
        t_ops = (g_flops + rest_flops) / PEAK_FLOPS[dtype_name] * 1e3
        t_fma = (max(g_flops / PEAK_FLOPS["bfloat16"],
                     rest_flops / PEAK_FLOPS["float32"]) * 1e3
                 if dtype == torch.bfloat16 else t_ops)
        nbytes = (2 * x.numel() * x.element_size() + 4 * dt.numel() + 4 * nh
                  + 2 * Bm.numel() * Bm.element_size()
                  + (2 if with_state else 1) * 4 * st.numel())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        return {
            "shape": [B, S, nh, hp], "N": N, "dtype": dtype_name,
            "init_state": with_state, "max_abs_err": abs_err, "rel_err": rel,
            "tol": SSD_TOL[dtype_name], "state_rel_err": state_rel,
            "state_tol": SSD_STATE_TOL, "ms": time_ms(run),
            "cold_ms": time_ms(run, cold=True),
            "plain_ms": time_ms(plain, iters=5), "library_ms": None,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_fma_ms": max(t_bytes, t_fma),
            "flops": g_flops + rest_flops, "bytes": nbytes,
        }

    ssd_cases = [ssd_case(1, 1024, 24, 64, 128, "bfloat16"),   # mamba2-130m
                 ssd_case(1, 1024, 64, 64, 64, "bfloat16"),    # zamba2-1.2b
                 ssd_case(1, 1000, 24, 64, 128, "bfloat16"),   # ragged S
                 ssd_case(1, 1024, 64, 64, 64, "bfloat16", with_state=True),
                 ssd_case(1, 128, 4, 32, 64, "float32"),       # the reference's
                 ssd_case(2, 256, 8, 32, 64, "float32"),
                 ssd_case(1, 128, 2, 64, 128, "float32"),
                 ssd_case(1, 4096, 24, 64, 128, "bfloat16")]   # 64 chunks
    # the dryrun phase's mamba2-130m prefill_32k part: 32,768-token rows, as
    # many as the dry run's estimate gives a part on this card now (the
    # dryrun phase holds the record's own part again where it differs)
    from repro_torch.configs import get_shape
    d_shape = get_shape("prefill_32k")
    d_model = build_model(dryrun.cell_config("mamba2-130m", d_shape), dev)
    ssd_long_rows = 32 // dryrun.choose_parts(
        32, dryrun.part_bytes_per_sequence(d_model, d_shape),
        dryrun.free_device_bytes(dev))
    del d_model
    ssd_long_case = ssd_case(ssd_long_rows, 32768, 24, 64, 128, "bfloat16")
    ssd_cases.append(ssd_long_case)
    def gmm_case(E, M, K, N, dtype_name, where, shared=False,
                 host="pin_memory"):
        """grouped_matmul against its plain version; x (E, M, K) (with
        ``shared`` one (M, K) buffer read by every expert, expert stride 0,
        as the MoE decode passes it); w (E, K, N) on the card or in pinned
        host memory: a block of the caching host allocator
        (``host="pin_memory"``) or a host-tier buffer of registered pages
        (``host="empty_host"``, as the runtime places a spilled stack).
        Bound: x read once (once in all when shared), w read once, the
        output written once; 2*E*M*K*N operations; a pinned w's bytes also
        cross the host link. Library: one torch.bmm on the same inputs
        (with a pinned w, after copying it over). A pinned case's rate is
        also given as a share of the 1 GiB copy's from a host-tier buffer
        (``link_share``: the kernel alone, cold)."""
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device=dev).manual_seed(SEED + E + M + K + N)
        x = torch.randn(1 if shared else E, M, K, device=dev, generator=g).to(dtype)
        x = x.expand(E, M, K) if shared else x
        w_dev = (torch.randn(E, K, N, device=dev, generator=g) * K ** -0.5).to(dtype)
        if where == "device":
            w = w_dev
        elif host == "empty_host":
            w = to_host(w_dev, dev)
        else:
            w = w_dev.cpu().pin_memory()
        before = gmm.grouped_matmul.h2d_bytes
        routes = dict(gmm.grouped_matmul.launches_by_route)
        got = gmm.grouped_matmul(x, w)
        h2d = gmm.grouped_matmul.h2d_bytes - before
        route = [r for r, n in gmm.grouped_matmul.launches_by_route.items()
                 if n != routes[r]]
        want = gmm.grouped_matmul_plain(x, w_dev)
        torch.cuda.synchronize()
        if not torch.isfinite(got.float()).all():
            fail(f"grouped_matmul gave non-finite values at {(E, M, K, N)}")
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        tol = STREAM_TOL[dtype_name]
        if rel >= tol:
            fail(f"grouped_matmul disagrees with its plain version at "
                 f"{(E, M, K, N)} {dtype_name} w {where} shared x {shared}: "
                 f"rel {rel:.3e} >= {tol}")
        es = x.element_size()
        w_bytes = E * K * N * es
        if h2d != (w_bytes if where == "pinned" else 0):
            fail(f"grouped_matmul streamed {h2d} bytes for a {where} w of "
                 f"{w_bytes} bytes")
        nbytes = ((1 if shared else E) * M * K + E * M * N) * es + w_bytes
        flops = 2.0 * E * M * K * N
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
        t_link = w_bytes / link_bound_rate * 1e3 if where == "pinned" else 0.0
        ms = time_ms(lambda: gmm.grouped_matmul(x, w))
        cold = time_ms(lambda: gmm.grouped_matmul(x, w), cold=True)
        lib_dev = time_ms(lambda: torch.bmm(x, w_dev))
        lib_host = (time_ms(lambda: torch.bmm(x, w.to(dev, non_blocking=True)))
                    if where == "pinned" else None)
        return {
            "shape": [E, M, K, N], "dtype": dtype_name, "where": where,
            "host_buffer": host if where == "pinned" else None,
            "route": route[0], "x_expert_stride": x.stride(0),
            "max_abs_err": abs_err, "rel_err": rel, "tol": tol, "ms": ms,
            "cold_ms": cold,
            "link_share": (w_bytes / (cold * 1e-3) / link_bytes_per_s
                           if where == "pinned" else None),
            "plain_ms": time_ms(lambda: gmm.grouped_matmul_plain(x, w_dev), iters=5),
            "library_ms": lib_host if lib_host is not None else lib_dev,
            "library_device_w_ms": lib_dev, "library_host_w_ms": lib_host,
            "bound_ms": max(t_bytes, t_ops, t_link),
            "bound_by": "bytes" if max(t_bytes, t_link) >= t_ops else "operations",
            "bytes": nbytes, "flops": flops, "h2d_bytes": h2d,
            "h2d_gb_per_s": h2d / (ms * 1e-3) / 1e9 if h2d else None,
        }

    # route by the wrapper's shape rule (grouped_matmul.plan): bf16 that TMA
    # can describe -> wgmma, other bf16 -> mma_sync, fp32 -> fma
    gmm_cases = [
        gmm_case(32, 4, 1024, 512, "bfloat16", "device", shared=True),  # decode
        gmm_case(32, 4, 512, 1024, "bfloat16", "device"),       # decode w_out
        gmm_case(32, 320, 1024, 512, "bfloat16", "device"),     # 1024-token prefill
        gmm_case(32, 4, 1024, 512, "bfloat16", "pinned", shared=True),
        gmm_case(32, 320, 1024, 512, "bfloat16", "pinned"),
        gmm_case(5, 77, 200, 96, "bfloat16", "device"),         # ragged C, d, f
        gmm_case(5, 77, 200, 96, "float32", "pinned"),
        gmm_case(32, 4, 1024, 512, "float32", "device", shared=True),
        gmm_case(2, 128, 128, 128, "float32", "device"),        # the reference's
        gmm_case(4, 256, 128, 384, "float32", "device"),
        gmm_case(1, 128, 256, 128, "float32", "device"),
        gmm_case(5, 77, 100, 96, "bfloat16", "device"),         # x rows of 200 B
        # granite-moe training, 8 x 1024 tokens: 8 groups x capacity 320
        gmm_case(32, 2560, 1024, 512, "bfloat16", "device"),    # w_in, w_gate
        gmm_case(32, 2560, 512, 1024, "bfloat16", "device")]    # w_out
    # phi3.5-moe-42b-a6.6b's path (moe_full): w_in and w_gate (4096 -> 6400)
    # at a 4-slot decode (one shared x) and a 1,024-token prefill (capacity
    # 160), w_gate streamed from a host-tier buffer as the runtime places
    # it; w_out (6400 -> 4096) on the card at both
    phi35_gmm_cases = [
        gmm_case(16, 4, 4096, 6400, "bfloat16", "device", shared=True),
        gmm_case(16, 4, 4096, 6400, "bfloat16", "pinned", shared=True,
                 host="empty_host"),
        gmm_case(16, 160, 4096, 6400, "bfloat16", "device"),
        gmm_case(16, 160, 4096, 6400, "bfloat16", "pinned", host="empty_host"),
        gmm_case(16, 4, 6400, 4096, "bfloat16", "device"),
        gmm_case(16, 160, 6400, 4096, "bfloat16", "device")]
    gmm_cases += phi35_gmm_cases
    want_routes = (["wgmma"] * 6 + ["fma"] * 5 + ["mma_sync"] + ["wgmma"] * 2
                   + ["wgmma"] * len(phi35_gmm_cases))
    got_routes = [c["route"] for c in gmm_cases]
    if got_routes != want_routes:
        fail(f"grouped_matmul routes {got_routes} != {want_routes}")
    for c in cases:
        if c["route"] != fa.FWD_ROUTES[getattr(torch, c["dtype"])]:
            fail(f"flash_attention_fwd took {c['route']} for {c['dtype']}")
    def panel_depths(E, M, K, N, host="pin_memory"):
        """The pinned decode (one shared x) at several panel depths
        (``grouped_matmul.BLOCK_K``): cold ms, the kernel and the link
        alone, so the depth the wrapper uses can be checked against the
        others on this card; w from the caching host allocator or a
        host-tier buffer (``host``, as in ``gmm_case``), each depth's panel
        (experts x K rows) and its rate as a share of the 1 GiB copy's."""
        g = torch.Generator(device=dev).manual_seed(SEED)
        x = torch.randn(1, M, K, device=dev, generator=g).to(torch.bfloat16)
        x = x.expand(E, M, K)
        w = (torch.randn(E, K, N, device=dev, generator=g) * K ** -0.5).to(
            torch.bfloat16)
        w = to_host(w, dev) if host == "empty_host" else w.cpu().pin_memory()
        w_bytes = w.numel() * w.element_size()
        kept, out, share = gmm.BLOCK_K, {}, {}
        try:
            for block_k in (2048, 4096, 8192, 16384):
                gmm.BLOCK_K = block_k
                out[block_k] = time_ms(lambda: gmm.grouped_matmul(x, w), cold=True)
                share[block_k] = w_bytes / (out[block_k] * 1e-3) / link_bytes_per_s
        finally:
            gmm.BLOCK_K = kept
        return {"shape": [E, M, K, N], "host_buffer": host, "used": kept,
                "panels": {bk: gmm.panel_shape(E, K, bk) for bk in out},
                "cold_ms": out, "link_share": share}

    def gmm_bwd_case(which, E, M, K, N):
        """One product of grouped_matmul's backward at granite-moe's training
        shapes (x (E, M, K), w (E, K, N), dy (E, M, N), bf16), as the
        autograd Function runs it: ``dx = dy @ w^T`` on w's transposed view
        ("nk"), or ``dw = x^T @ dy`` on x's transposed view (the wgmma
        kernel's transposed A); neither copies an operand (``copy_bytes``,
        checked 0). Held to the plain version under the bf16 tolerance.
        Bound: the inputs read once and the output written once; 2*E*M*K*N
        operations. Library: one torch.bmm on the same transposed views."""
        g = torch.Generator(device=dev).manual_seed(SEED + 11 * M + N)
        x = torch.randn(E, M, K, device=dev, generator=g).to(torch.bfloat16)
        w = (torch.randn(E, K, N, device=dev, generator=g) * K ** -0.5).to(
            torch.bfloat16)
        dy = torch.randn(E, M, N, device=dev, generator=g).to(torch.bfloat16)
        if which == "dx":
            a, b = dy, w.transpose(1, 2)
            run = lambda: gmm._launch(dy, w.transpose(1, 2))
        else:
            a, b = x.transpose(1, 2), dy
            run = lambda: gmm._launch(gmm.transposed_x(x, dy), dy)
        routes = dict(gmm.grouped_matmul.launches_by_route)
        copied = gmm.grouped_matmul.transpose_bytes
        got = run()
        copy_bytes = gmm.grouped_matmul.transpose_bytes - copied
        route = [r for r, n in gmm.grouped_matmul.launches_by_route.items()
                 if n != routes[r]]
        want = gmm.grouped_matmul_plain(a, b)
        torch.cuda.synchronize()
        abs_err = float((got.float() - want.float()).abs().max())
        rel = abs_err / (float(want.float().abs().max()) + 1e-9)
        if not torch.isfinite(got.float()).all() or rel >= TOL["bfloat16"]:
            fail(f"grouped_matmul backward {which} disagrees with its plain "
                 f"version at {(E, M, K, N)}: rel {rel:.3e}")
        if route != ["wgmma"] or copy_bytes:
            fail(f"grouped_matmul backward {which} took {route}, not wgmma, "
                 f"or copied {copy_bytes} bytes")
        nbytes = (a.numel() + b.numel() + got.numel()) * 2
        bound_ms, bound_by = bound(nbytes, 2.0 * E * M * K * N, "bfloat16")
        return {"product": which, "shape": [E, M, K, N], "dtype": "bfloat16",
                "operands": [list(a.shape), list(b.shape)], "route": route[0],
                "max_abs_err": abs_err, "rel_err": rel, "tol": TOL["bfloat16"],
                "ms": time_ms(run), "cold_ms": time_ms(run, cold=True),
                "plain_ms": time_ms(lambda: gmm.grouped_matmul_plain(a, b),
                                    iters=5),
                "library_ms": time_ms(lambda: torch.bmm(a, b)),
                "library": "torch.bmm", "bound_ms": bound_ms,
                "bound_by": bound_by, "copy_bytes": copy_bytes}

    # granite-moe at 8 x 1024 tokens (capacity 320 x 8 groups): w_in and
    # w_gate (1024 -> 512), then w_out (512 -> 1024)
    gmm_bwd_cases = [gmm_bwd_case(which, 32, 2560, K, N)
                     for K, N in ((1024, 512), (512, 1024))
                     for which in ("dx", "dw")]

    def ssd_bwd_case(B, S, nh, hp, N):
        """The SSD Function (models.ssm.ssd_autograd, the kernel as its
        forward) at a training shape. Its forward, the kernel, held to
        ssd_chunked on the same inputs: y under SSD_TOL and the final state
        under SSD_STATE_TOL, in fp32 and in bf16 (x, B_, C_ bf16, the
        training dtype). Its gradients against autograd through ssd_chunked
        (fp32, 1e-4 relative, every input): the backward recomputes
        ssd_chunked and never reads the kernel's output, so this checks the
        Function's wiring, not the kernel. And the time of its backward
        (plain torch) in bf16."""
        ins = []
        g = torch.Generator(device=dev).manual_seed(SEED + nh + N)
        for dtype in (torch.float32, torch.bfloat16):
            gg = torch.Generator(device=dev).manual_seed(SEED + nh + N)
            ins.append([
                (0.5 * torch.randn(B, S, nh, hp, device=dev, generator=gg)).to(dtype),
                torch.nn.functional.softplus(
                    torch.randn(B, S, nh, device=dev, generator=gg)),
                -torch.exp(0.3 * torch.randn(nh, device=dev, generator=gg)),
                (0.3 * torch.randn(B, S, N, device=dev, generator=gg)).to(dtype),
                (0.3 * torch.randn(B, S, N, device=dev, generator=gg)).to(dtype)])
        forward = {}
        for dtype_name, args in zip(("float32", "bfloat16"), ins):
            before = ssd.ssd_scan.launches
            y, st = mssm.ssd_autograd(mssm.ssd_kernel, *args, 128)
            launched = ssd.ssd_scan.launches - before
            py, pst = mssm.ssd_chunked(*args, 128)
            torch.cuda.synchronize()
            forward[dtype_name] = {
                "y_rel_err": rel_err(y, py), "tol": SSD_TOL[dtype_name],
                "state_rel_err": rel_err(st, pst), "state_tol": SSD_STATE_TOL}
            f = forward[dtype_name]
            if (launched != 1 or not f["y_rel_err"] < f["tol"]
                    or not f["state_rel_err"] < SSD_STATE_TOL):
                fail(f"the SSD Function's forward ({launched} kernel "
                     f"launches) disagrees with ssd_chunked at "
                     f"{(B, S, nh, hp, N)} {dtype_name}: {f}")
            del y, st, py, pst
        dy = torch.randn(B, S, nh, hp, device=dev, generator=g)
        grads = []
        for fn in ("kernel", "plain"):
            leaves = [t.clone().requires_grad_() for t in ins[0]]
            y, _ = (mssm.ssd_autograd(mssm.ssd_kernel, *leaves, 128)
                    if fn == "kernel" else mssm.ssd_chunked(*leaves, 128))
            grads.append(torch.autograd.grad(y, leaves, dy))
        torch.cuda.synchronize()
        errs = {name: rel_err(a, b) for name, a, b in zip(
            ("x", "dt", "A", "B_", "C_"), *grads)}
        if not max(errs.values()) < 1e-4:          # NaN fails too
            fail(f"the SSD Function's gradients disagree with autograd "
                 f"through ssd_chunked at {(B, S, nh, hp, N)}: {errs}")
        del grads
        leaves = [t.clone().requires_grad_() for t in ins[1]]
        y, _ = mssm.ssd_autograd(mssm.ssd_kernel, *leaves, 128)
        dyb = dy.to(torch.bfloat16)
        bwd = lambda: torch.autograd.grad(y, leaves, dyb, retain_graph=True)
        return {"shape": [B, S, nh, hp], "N": N,
                "forward_vs_ssd_chunked": forward,
                "grad_rel_err_fp32": errs, "grad_tol": 1e-4,
                "grad_checks": "the Function's wiring (its backward is "
                               "ssd_chunked's)",
                "dtype": "bfloat16",
                "backward_ms": time_ms(bwd, warmup=1, iters=5),
                "forward_ms": time_ms(lambda: mssm.ssd_kernel(*ins[1], 128)),
                "backward": "plain torch: ssd_chunked recomputed under autograd"}

    ssd_bwd_cases = [ssd_bwd_case(8, 1024, 24, 64, 128),   # mamba2-130m training
                     ssd_bwd_case(8, 1024, 64, 64, 64)]    # zamba2-1.2b training

    # phi3.5-moe's streamed decode: 2-expert panels of 105 MB by default
    gmm_phi35_depths = panel_depths(16, 4, 4096, 6400, host="empty_host")

    hq, hk, hv = (torch.randn(32, 1024, 128, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    hx = torch.randn(1, 4, 1024, device=dev).to(torch.bfloat16).expand(32, 4, 1024)
    hw = torch.randn(32, 1024, 512, device=dev).to(torch.bfloat16)
    wrapper_host_us = {
        "grouped_matmul decode (32,4,1024,512)": host_us(
            lambda: gmm.grouped_matmul(hx, hw)),
        "torch.bmm, the same": host_us(lambda: torch.bmm(hx, hw)),
        "flash_attention_fwd (32,1024,128)": host_us(
            lambda: fa.flash_attention_fwd(hq, hk, hv)),
        "scaled_dot_product_attention, the same": host_us(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                hq[None], hk[None], hv[None], is_causal=True))}
    del hq, hk, hv, hx, hw
    emit("kernels", flash_attention_fwd=cases, flash_attention_train=train_cases,
         stream_matmul=stream_cases, stream_matmul_ring_depths=stream_ring_depths,
         link_memcpy_gb_per_s=link_bytes_per_s / 1e9,
         link_memcpy_caching_allocator_gb_per_s=link_alloc_bytes_per_s / 1e9,
         ssd_scan=ssd_cases, ssd_function_backward=ssd_bwd_cases,
         grouped_matmul=gmm_cases, grouped_matmul_backward=gmm_bwd_cases,
         grouped_matmul_panel_depths=panel_depths(32, 4, 1024, 512),
         grouped_matmul_panel_depths_phi35=gmm_phi35_depths,
         wrapper_host_us=wrapper_host_us,
         ssd_scan_library="none: no single PyTorch call computes the SSD scan",
         host_link={"peak_gb_per_s": HOST_LINK_BYTES_PER_S / 1e9,
                    "bound_gb_per_s": link_bound_rate / 1e9,
                    "measured_ms_per_gib": link_ms,
                    "measured_gb_per_s": link_bytes_per_s / 1e9,
                    "measured_caching_allocator_gb_per_s":
                        link_alloc_bytes_per_s / 1e9})

    # ---------------------------------------------------------------- serve
    def timed_engine(engine):
        """Stamp prefill and tick wall times (synchronised) on an engine."""
        engine.prefill_s, engine.tick_s = [], []
        prefill, tick = engine.prefill, engine.tick

        def timed_prefill(req):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ok = prefill(req)
            torch.cuda.synchronize()
            engine.prefill_s.append((len(req.prompt), time.perf_counter() - t))
            return ok

        def timed_tick():
            torch.cuda.synchronize()
            t, n_pre = time.perf_counter(), len(engine.prefill_s)
            n = tick()
            torch.cuda.synchronize()
            spent = time.perf_counter() - t
            spent -= sum(s for _, s in engine.prefill_s[n_pre:])
            engine.tick_s.append(spent)       # decode part of the tick
            return n

        engine.prefill, engine.tick = timed_prefill, timed_tick
        return engine

    def make_requests(cfg, lens, max_new):
        rng = np.random.default_rng(SEED)
        return [Request(i, rng.integers(0, cfg.vocab_size, size=n).astype(np.int32),
                        max_new) for i, n in enumerate(lens)]

    def check_outputs(out, reqs, cfg, max_new):
        if sorted(out) != [r.rid for r in reqs]:
            fail(f"missing requests: {sorted(out)}")
        for rid, toks in out.items():
            if len(toks) != max_new:
                fail(f"request {rid} returned {len(toks)} tokens, not {max_new}")
            if min(toks) < 0 or max(toks) >= cfg.vocab_size:
                fail(f"request {rid}: token id out of range")

    def run_engine(engine, reqs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.run(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    LENS = [16, 100, 128, 300, 512, 777, 1000, 1024]
    SLOTS, MAX_SEQ, MAX_NEW = 4, 2048, 16

    def dense_param_count(cfg):
        """The config's analytic count (the reference's formula) counts a
        layernorm's scale alone; both packages' init also create its bias:
        two norms a layer and the final one."""
        biases = (2 * cfg.num_layers + 1) * cfg.d_model
        return cfg.param_count() + (biases if cfg.norm == "layernorm" else 0)

    def serve_full_size(phase, arch):
        """``arch`` at full width and depth (random bf16 weights from a seed)
        through ServingEngine.run after a warm-up, the counts set to 0 just
        before and read just after: every prefill's flash launch (admitted x
        layers, all wgmma), the parameter count and the outputs checked.
        Returns (model, params, cfg, row, outputs, launches, routes); the
        caller emits ``row``."""
        gc.collect()
        torch.cuda.empty_cache()
        mem_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg = get_config(arch).with_(attn_impl="pallas", remat="none",
                                     param_dtype="bfloat16")
        model = build_model(cfg, dev)
        t0 = time.time()
        params, _ = model.init(torch.Generator(device=dev).manual_seed(SEED))
        torch.cuda.synchronize()
        init_s = time.time() - t0
        leaves = list(tree_leaves(params))
        n_params = sum(t.numel() for t in leaves)
        if n_params != dense_param_count(cfg):
            fail(f"{phase}: parameter count {n_params} != the config's "
                 f"{cfg.param_count()} + layernorm biases")
        weight_bytes = sum(t.numel() * t.element_size() for t in leaves)
        # warm-up: the same prompts once, so that first-use costs (library
        # handles, kernels loaded per shape) are not timed as serving
        run_engine(ServingEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ),
                   make_requests(cfg, LENS, 2))
        engine = timed_engine(ServingEngine(model, params, slots=SLOTS,
                                            max_seq=MAX_SEQ))
        reqs = make_requests(cfg, LENS, MAX_NEW)
        reset_counts()                               # main path starts here
        out, wall = run_engine(engine, reqs)
        launches = {n: w.launches for n, w in kernel_wrappers.items()}
        routes = route_counts()
        check_outputs(out, reqs, cfg, MAX_NEW)
        want = engine.stats.admitted * cfg.num_layers
        check_launches(phase, launches, {**{n: 0 for n in kernel_wrappers},
                                         "flash_attention_fwd": want})
        check_launches(f"{phase} routes", routes["flash_attention_fwd"],
                       {"wgmma": want, "fma": 0})
        tokens = sum(len(v) for v in out.values())
        row = dict(
            arch=cfg.name, card=card_line, layers=cfg.num_layers,
            d_model=cfg.d_model, heads=cfg.num_heads,
            kv_heads=cfg.num_kv_heads, gqa_group=cfg.num_heads // cfg.num_kv_heads,
            vocab=cfg.vocab_size, tied_embeddings=cfg.tie_embeddings,
            rope_theta=cfg.rope_theta, params=n_params,
            param_count_analytic=cfg.param_count(), param_dtype=cfg.param_dtype,
            weight_bytes=weight_bytes, init_seconds=init_s,
            requests=len(out), prompt_lens=LENS, slots=SLOTS, max_seq=MAX_SEQ,
            tokens=tokens, ticks=engine.ticks, admitted=engine.stats.admitted,
            wall_seconds=wall, tok_per_s=tokens / wall,
            prefill_ms={str(n): s * 1e3 for n, s in engine.prefill_s},
            prefill_ms_median=statistics.median(
                s for _, s in engine.prefill_s) * 1e3,
            tick_ms_median=statistics.median(engine.tick_s) * 1e3,
            tick_ms_max=max(engine.tick_s) * 1e3,
            kv_pool_bytes=model.cache_bytes(SLOTS, MAX_SEQ),
            flash_attention_fwd_launches=launches["flash_attention_fwd"],
            launches_formula="admitted x layers",
            launches_by_route=routes["flash_attention_fwd"],
            max_memory_allocated=torch.cuda.max_memory_allocated(),
            memory_allocated_before=mem_before)
        return model, params, cfg, row, out, launches, routes

    (model, params, cfg, serve_row, base_tokens, main_path_launches,
     main_path_routes) = serve_full_size("serve", "llama3-8b")
    emit("serve", **serve_row)

    # ---------------------------------------------------------------- check
    def logit_checks(phase, model, params, cfg):
        """301 tokens' logits through the flash kernel against an eager model
        on the same parameter tensors (no second copy of the weights), and
        prefill 300 tokens -> decode the 301st against the full forward's
        last row. Returns (kernel_vs_eager, decode_vs_forward, argmax_agree)."""
        rng = np.random.default_rng(SEED + 1)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 301)),
                               device=dev)
        logits_k, _, _ = model.forward(params, {"tokens": toks})
        eager = build_model(cfg.with_(attn_impl="xla"), dev)
        logits_e, _, _ = eager.forward(params, {"tokens": toks})
        if tuple(logits_k.shape) != (1, 301, cfg.vocab_size):
            fail(f"{phase}: logits shape {tuple(logits_k.shape)}")
        if not torch.isfinite(logits_k.float()).all():
            fail(f"{phase}: non-finite logits")
        kernel_vs_eager = rel_err(logits_k, logits_e)
        argmax_agree = float((logits_k.argmax(-1) == logits_e.argmax(-1))
                             .float().mean())
        _, _, pc = model.forward(params, {"tokens": toks[:, :300]},
                                 return_cache=True)
        cache = model.init_cache(1, 512)
        for name in cache:
            cache[name][:, :, :300] = pc[name].to(cache[name].dtype)
        dec, _ = model.decode(params, cache, {"tokens": toks[:, 300:301],
                                              "pos": torch.tensor(300, device=dev)})
        decode_vs_forward = rel_err(dec[0], logits_k[0, -1])
        torch.cuda.synchronize()
        if not torch.isfinite(dec.float()).all():
            fail(f"{phase}: non-finite decode logits")
        if kernel_vs_eager >= MODEL_TOL or decode_vs_forward >= MODEL_TOL:
            fail(f"{phase}: full-width logits disagree: kernel vs eager "
                 f"{kernel_vs_eager:.3e}, decode vs forward "
                 f"{decode_vs_forward:.3e} (limit {MODEL_TOL})")
        return kernel_vs_eager, decode_vs_forward, argmax_agree

    kernel_vs_eager, decode_vs_forward, argmax_agree = logit_checks(
        "check", model, params, cfg)
    emit("check", kernel_vs_eager_rel=kernel_vs_eager,
         decode_vs_forward_rel=decode_vs_forward, tol=MODEL_TOL,
         argmax_agree=argmax_agree)

    # -------------------------------------------------------------- offload
    inventory = model.serving_inventory(params, model.cache_shapes(SLOTS, MAX_SEQ))
    total = sum(t.bytes for t in inventory)
    embed = sum(t.bytes for t in inventory if t.group == "embed")
    kv = sum(t.bytes for t in inventory if t.group == "kv_cache")
    # the embedding table spills first (coldest per byte); the budget sits a
    # quarter of the KV bytes below what is left, so a KV leaf must split
    hbm_budget = total - embed - kv // 4
    plan = plan_offload(inventory, hbm_budget)
    if not plan.fits:
        fail("offload plan does not fit its budget")
    # whole-leaf placement by the same plan, on stand-ins of two parameters:
    # the spilled table lands in pinned host memory, the rest on the device
    placed = place_tree({"params": {"tok_embed": torch.ones(8, 8, device=dev),
                                    "lm_head": torch.ones(8, 8, device=dev)}},
                        plan, dev)["params"]
    placed_kinds = {n: memory_kind_of(t) for n, t in placed.items()}
    if placed_kinds != {"tok_embed": "pinned_host", "lm_head": "device"}:
        fail(f"place_tree put leaves in {placed_kinds}")
    engines = {
        "device": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ),
        "split": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ,
                                      plan=plan),
        "host": lambda: TenantEngine(model, params, slots=SLOTS, max_seq=MAX_SEQ,
                                     offload_kv=True),
    }
    want_kinds = {"device": {"device"}, "split": {"device", "pinned_host"},
                  "host": {"pinned_host"}}
    rows = {}
    for name, make in engines.items():
        eng = timed_engine(make())
        pool = eng.pool
        if pool.memory_kinds() != want_kinds[name]:
            fail(f"{name}: memory kinds {pool.memory_kinds()} != {want_kinds[name]}")
        if not all(t.is_pinned() for t in pool.host_tensors()):
            fail(f"{name}: a host-tier buffer is not pinned")
        if pool.device_bytes + pool.host_bytes != model.cache_bytes(SLOTS, MAX_SEQ):
            fail(f"{name}: device + host bytes != pool size")
        if (name == "split") != bool(pool.split_leaves):
            fail(f"{name}: split_leaves = {pool.split_leaves}")
        o_reqs = make_requests(cfg, LENS, MAX_NEW)
        o_out, o_wall = run_engine(eng, o_reqs)
        check_outputs(o_out, o_reqs, cfg, MAX_NEW)
        if o_out != base_tokens:
            fail(f"{name}: tokens differ from the device-pool serve run")
        if pool.memory_kinds() != want_kinds[name]:
            fail(f"{name}: pool migrated to {pool.memory_kinds()} while serving")
        rows[name] = {
            "device_bytes": pool.device_bytes, "host_bytes": pool.host_bytes,
            "split_leaves": pool.split_leaves,
            "memory_kinds": sorted(pool.memory_kinds()),
            "wall_seconds": o_wall, "tok_per_s": serve_row["tokens"] / o_wall,
            "tick_ms_median": statistics.median(eng.tick_s) * 1e3,
            "prefill_ms_median": statistics.median(s for _, s in eng.prefill_s) * 1e3,
            "h2d_bytes_per_tick": pool.h2d_bytes / max(eng.ticks, 1),
            "d2h_bytes_per_tick": pool.d2h_bytes / max(eng.ticks, 1),
            "paste_host_bytes": pool.paste_host_bytes, "ticks": eng.ticks,
        }
        del eng, pool
        torch.cuda.empty_cache()
    emit("offload", hbm_budget=hbm_budget, footprint=total,
         plan={"offloaded": list(plan.offloaded), "partial": list(plan.partial),
               "resident_bytes": plan.resident_bytes, "host_bytes": plan.host_bytes},
         plan_applied_to="kv pool (parameters stay on the device)",
         place_tree_kinds=placed_kinds,
         tokens_equal=True, **rows)
    del params, model
    gc.collect()              # the engines' timing wrappers form cycles
    torch.cuda.empty_cache()

    # -------------------------------------------------------------- runtime
    gcfg = get_config("gpt2-124m").with_(attn_impl="pallas", remat="none")
    meta = build_model(cfg, dev)
    meta_inv = meta.serving_inventory(meta.init(abstract=True)[0],
                                      meta.cache_shapes(SLOTS, MAX_SEQ))
    footprint = sum(t.bytes for t in meta_inv)
    embed = sum(t.bytes for t in meta_inv if t.group == "embed")
    kv = sum(t.bytes for t in meta_inv if t.group == "kv_cache")
    # one byte over what spilling the table and the KV pool frees: by the
    # planner's order the next spill is one whole stacked MLP matrix
    llm_budget = footprint - embed - kv - 1
    rt = SliceRuntime(device=dev)
    t0 = time.time()
    llm = rt.add_tenant(TenantSpec("llm", cfg, profile="2s.32c", slots=SLOTS,
                                   max_seq=MAX_SEQ, hbm_budget=llm_budget,
                                   seed=SEED))
    gpt = rt.add_tenant(TenantSpec("gpt2", gcfg, profile="1s.16c", slots=SLOTS,
                                   max_seq=256, seed=SEED))
    torch.cuda.synchronize()
    add_s = time.time() - t0
    plan = llm.plan
    streamed = [n for n in plan.offloaded if n.startswith("params/layers/")]
    if not streamed:
        fail(f"the plan spills no layer matrix: {plan}")
    host_leaves = {}
    for name in streamed:
        leaf = llm.params["layers"][name.split("/")[-1]]
        if memory_kind_of(leaf) != "pinned_host" or not leaf.is_pinned():
            fail(f"{name} is not in pinned host memory after placement")
        host_leaves[name] = leaf
    want_kinds = {"pinned_host" if plan.is_offloaded(f"kv/{n}") else "device"
                  for n in ("k", "v")}
    if llm.engine.pool.memory_kinds() != want_kinds:
        fail(f"llm pool kinds {llm.engine.pool.memory_kinds()} != {want_kinds}")
    for t in rt.tenants.values():
        timed_engine(t.engine)
    llm_reqs = make_requests(cfg, LENS, MAX_NEW)
    g_reqs = make_requests(gcfg, [5, 33, 64, 100], 8)
    rt.submit("llm", llm_reqs)
    rt.submit("gpt2", g_reqs)
    reset_counts()                                   # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = rt.run()
    torch.cuda.synchronize()
    rt_wall = time.perf_counter() - t0
    rt_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    rt_stream_routes = dict(sm.stream_matmul.launches_by_route)
    weight_h2d = sm.stream_matmul.h2d_bytes
    embed_h2d = mlayers.gather_rows.h2d_bytes
    check_outputs(llm.engine.outputs, llm_reqs, cfg, MAX_NEW)
    check_outputs(gpt.engine.outputs, g_reqs, gcfg, 8)
    lst = llm.engine.stats
    calls = (lst.admitted + lst.ticks) * cfg.num_layers * len(streamed)
    if rt_launches["stream_matmul"] != calls:
        fail(f"stream_matmul launched {rt_launches['stream_matmul']} times, "
             f"expected (prefills + ticks) x layers x matrices = {calls}")
    check_launches("runtime stream_matmul routes", rt_stream_routes,
                   planned_stream_routes(llm.engine, cfg.num_layers * len(streamed)))
    slice_bytes = sum(leaf[0].numel() * leaf.element_size()
                      for leaf in host_leaves.values()) // len(streamed)
    if weight_h2d != calls * slice_bytes:
        fail(f"stream_matmul streamed {weight_h2d} bytes, expected "
             f"{calls} calls x {slice_bytes} bytes")
    want_flash = (lst.admitted * cfg.num_layers
                  + gpt.engine.stats.admitted * gcfg.num_layers)
    if rt_launches["flash_attention_fwd"] != want_flash:
        fail(f"flash_attention_fwd launched {rt_launches['flash_attention_fwd']}"
             f" times in the runtime, expected {want_flash}")
    row_bytes = cfg.d_model * llm.params["tok_embed"].element_size()
    want_embed = (lst.prefill_tokens + lst.ticks * SLOTS) * row_bytes
    if plan.is_offloaded("params/tok_embed") and embed_h2d != want_embed:
        fail(f"embedding rows moved {embed_h2d} bytes, expected {want_embed}")
    if report["pod_utilization"] != 48 / 256:
        fail(f"pod utilization {report['pod_utilization']} != 48/256")
    if not 0 < report["modeled"]["throttle"] <= 1:
        fail(f"modeled throttle {report['modeled']['throttle']}")

    # the co-run must not change the tenant's tokens: a lone engine over the
    # same placed parameters and plan, with stream_matmul timed per call
    sm_events = []
    ops_stream_matmul = kops.stream_matmul

    def timed_stream_matmul(*a, **k):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = ops_stream_matmul(*a, **k)
        end.record()
        sm_events.append((start, end))
        return out

    lone = timed_engine(TenantEngine(llm.model, llm.params, slots=SLOTS,
                                     max_seq=MAX_SEQ, plan=plan))
    kops.stream_matmul = timed_stream_matmul
    lone_ticks_sm = []
    tick = lone.tick

    def tick_with_share():
        n_before = len(sm_events)
        n_pre = len(lone.prefill_s)
        emitted = tick()        # timed_engine's wrapper: synchronised
        per_prefill = cfg.num_layers * len(streamed) * (len(lone.prefill_s) - n_pre)
        lone_ticks_sm.append(sum(s.elapsed_time(e) for s, e in
                                 sm_events[n_before + per_prefill:]))
        return emitted

    lone.tick = tick_with_share
    try:
        lone_out, lone_wall = run_engine(lone, make_requests(cfg, LENS, MAX_NEW))
    finally:
        kops.stream_matmul = ops_stream_matmul
    if lone_out != llm.engine.outputs:
        fail("llm tokens of the co-run differ from a lone engine's")

    # full-width logits: host-placed parameters vs all on the device
    rng = np.random.default_rng(SEED + 1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 301)), device=dev)
    on_device = dict(llm.params)
    on_device["layers"] = {k: v.to(dev) for k, v in llm.params["layers"].items()}
    on_device["tok_embed"] = llm.params["tok_embed"].to(dev)
    logits_h, _, _ = llm.model.forward(llm.params, {"tokens": toks})
    logits_d, _, _ = llm.model.forward(on_device, {"tokens": toks})
    torch.cuda.synchronize()
    placed_vs_device = rel_err(logits_h, logits_d)
    if not torch.isfinite(logits_h.float()).all() or placed_vs_device >= MODEL_TOL:
        fail(f"host-placed vs device logits: rel {placed_vs_device:.3e} "
             f"(limit {MODEL_TOL})")
    argmax_agree = float((logits_h.argmax(-1) == logits_d.argmax(-1)).float().mean())
    del on_device, logits_h, logits_d

    def tier_bytes(t):
        kinds = {}
        for leaf in list(t.params["layers"].values()) + [
                v for k, v in t.params.items() if k != "layers"]:
            kind = memory_kind_of(leaf)
            kinds[kind] = kinds.get(kind, 0) + leaf.numel() * leaf.element_size()
        return {"params_by_kind": kinds,
                "kv_device_bytes": t.engine.pool.device_bytes,
                "kv_host_bytes": t.engine.pool.host_bytes}

    tenants_out = {}
    for t in rt.tenants.values():
        row = report["tenants"][t.name]
        tenants_out[t.name] = {
            "arch": t.spec.cfg.name, "profile": row["profile"],
            "rect": row["rect"], "tokens": row["tokens_out"],
            "tok_per_s": row["tok_per_s"], "ticks": row["ticks"],
            "tick_ms_median": statistics.median(t.engine.tick_s) * 1e3,
            "prefill_ms_median": statistics.median(
                s for _, s in t.engine.prefill_s) * 1e3,
            **tier_bytes(t)}
    sm_tick_ms = statistics.median(lone_ticks_sm)
    lone_tick_ms = statistics.median(lone.tick_s) * 1e3
    emit("runtime", footprint=footprint, hbm_budget=llm_budget,
         plan={"offloaded": list(plan.offloaded), "partial": list(plan.partial),
               "resident_bytes": plan.resident_bytes, "host_bytes": plan.host_bytes},
         add_tenants_seconds=add_s, wall_seconds=rt_wall, tenants=tenants_out,
         llm_prefills=lst.admitted, llm_ticks=lst.ticks,
         launches=rt_launches, stream_matmul_launches_by_route=rt_stream_routes,
         stream_matmul_h2d_bytes=weight_h2d,
         weight_h2d_bytes_per_call=slice_bytes,
         weight_h2d_bytes_per_tick=slice_bytes * cfg.num_layers * len(streamed),
         embed_h2d_bytes=embed_h2d,
         lone_tokens_equal=True, lone_tick_ms_median=lone_tick_ms,
         stream_matmul_ms_per_tick_median=sm_tick_ms,
         stream_matmul_share_of_tick=sm_tick_ms / lone_tick_ms,
         placed_vs_device_rel=placed_vs_device, tol=MODEL_TOL,
         argmax_agree=argmax_agree, pod_utilization=report["pod_utilization"],
         modeled_not_this_card=report["modeled"])
    for name in list(rt.tenants):
        rt.remove_tenant(name)
    del rt, llm, gpt, lone, tick, tick_with_share, host_leaves, report
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- gpt2
    gmodel = build_model(gcfg, dev)
    gparams, _ = gmodel.init(torch.Generator(device=dev).manual_seed(SEED))
    geng = timed_engine(ServingEngine(gmodel, gparams, slots=2, max_seq=256))
    greqs = make_requests(gcfg, [5, 33, 64, 100], 8)
    before = fa.flash_attention_fwd.launches
    gout, gwall = run_engine(geng, greqs)
    check_outputs(gout, greqs, gcfg, 8)
    if fa.flash_attention_fwd.launches - before != 4 * gcfg.num_layers:
        fail("gpt2: kernel launch count != admitted x layers")
    geager = build_model(gcfg.with_(attn_impl="xla"), dev)
    gt = torch.as_tensor(greqs[3].prompt.astype(np.int64), device=dev)[None]
    g_rel = rel_err(gmodel.forward(gparams, {"tokens": gt})[0],
                    geager.forward(gparams, {"tokens": gt})[0])
    if g_rel >= MODEL_TOL:
        fail(f"gpt2 logits: kernel vs eager rel {g_rel:.3e} >= {MODEL_TOL}")
    emit("gpt2", arch=gcfg.name, layers=gcfg.num_layers, tokens=sum(map(len, gout.values())),
         ticks=geng.ticks, wall_seconds=gwall,
         tick_ms_median=statistics.median(geng.tick_s) * 1e3,
         kernel_vs_eager_rel=g_rel)
    del gmodel, gparams, geng, geager
    torch.cuda.empty_cache()

    # ------------------------------------- serve_starcoder2, serve_command_r
    def serve_and_free(phase, arch):
        """The serve phase's path at ``arch``, then the check phase's logit
        checks on the same parameter tensors; the model is freed and device
        memory must come back within 64 MiB of where it was before."""
        model, params, cfg, row, _, launches, routes = serve_full_size(phase, arch)
        kernel_vs_eager, decode_vs_forward, argmax_agree = logit_checks(
            phase, model, params, cfg)
        peak = torch.cuda.max_memory_allocated()     # serving and the checks
        del model, params
        gc.collect()          # the engines' timing wrappers form cycles
        torch.cuda.empty_cache()
        mem_after = torch.cuda.memory_allocated()
        if abs(mem_after - row["memory_allocated_before"]) > 64 << 20:
            fail(f"{phase}: device memory {mem_after} bytes after the phase, "
                 f"{row['memory_allocated_before']} before (more than 64 MiB "
                 f"apart)")
        emit(phase, **row, kernel_vs_eager_rel=kernel_vs_eager,
             decode_vs_forward_rel=decode_vs_forward, tol=MODEL_TOL,
             argmax_agree=argmax_agree, max_memory_allocated_with_checks=peak,
             memory_allocated_after=mem_after)
        return launches, routes

    starcoder2_launches, starcoder2_routes = serve_and_free(
        "serve_starcoder2", "starcoder2-7b")
    command_r_launches, command_r_routes = serve_and_free(
        "serve_command_r", "command-r-35b")

    # ---------------------------------------------------------------- train
    tcfg = build_config("gpt2-124m", full_size=True, attn_impl="xla_cv",
                        remat="layer")
    L = tcfg.num_layers
    gc.collect()              # the engines' timing wrappers form cycles
    torch.cuda.empty_cache()
    train_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
        reset_counts()                               # main path starts here
        t0 = time.perf_counter()
        tstats = run_training(tcfg, steps=T_STEPS, batch=T_BATCH, seq=T_SEQ,
                              lr=3e-3, device=dev, ckpt_dir=ckpt_dir,
                              ckpt_every=CKPT_EVERY, inject_failure_at=FAIL_AT,
                              seed=SEED)
        torch.cuda.synchronize()
        train_wall = time.perf_counter() - t0
        train_launches = {n: w.launches for n, w in kernel_wrappers.items()}
        train_routes = route_counts()
    train_peak = torch.cuda.max_memory_allocated()
    # the failure at step FAIL_AT restores the checkpoint of the last
    # multiple of CKPT_EVERY, so the steps between run twice
    rerun = FAIL_AT % CKPT_EVERY
    steps_done = tstats.steps_done
    if (steps_done != T_STEPS + rerun or tstats.restarts != 1
            or len(tstats.repartitions) != 1):
        fail(f"train: steps {steps_done} (expected {T_STEPS + rerun}), "
             f"restarts {tstats.restarts}, repartitions {tstats.repartitions}")
    if not all(np.isfinite(tstats.losses)):
        fail(f"train: non-finite loss {tstats.losses}")
    loss_first, loss_last5 = tstats.losses[0], statistics.mean(tstats.losses[-5:])
    if loss_first - loss_last5 < 0.5:
        fail(f"train: loss {loss_first:.4f} -> {loss_last5:.4f} fell less than "
             f"0.5 nat")
    # remat="layer": per layer and step one forward, one recomputed forward
    # in the backward, and one backward (both of its kernels)
    launch_formula = {
        "flash_attention_fwd_stats": ("2 x layers x steps", 2 * L * steps_done),
        "flash_attention_bwd_dkdv": ("layers x steps", L * steps_done),
        "flash_attention_bwd_dq": ("layers x steps", L * steps_done),
        "flash_attention_fwd": ("0 (serving only)", 0),
        "stream_matmul": ("0 (weights on the device)", 0),
        "ssd_scan": ("0 (no SSM layer)", 0),
        "grouped_matmul": ("0 (no MoE layer)", 0)}
    if train_launches != {n: want for n, (_, want) in launch_formula.items()}:
        fail(f"train: launches {train_launches} != {launch_formula}")
    # the model trains in bf16: every flash launch on the wgmma kernels
    check_launches("train routes", train_routes, {
        n: {"wgmma": train_launches[n], "fma": 0}
        for n in ("flash_attention_fwd", "flash_attention_fwd_stats",
                  "flash_attention_bwd_dkdv", "flash_attention_bwd_dq")}
        | {"grouped_matmul": {"wgmma": 0, "mma_sync": 0, "fma": 0}})
    step_ms = statistics.median(tstats.step_seconds) * 1e3
    emit("train", arch=tcfg.name, layers=L, d_model=tcfg.d_model,
         vocab=tcfg.vocab_size, params=tcfg.param_count(),
         param_dtype=tcfg.param_dtype, dtype=tcfg.dtype,
         attn_impl=tcfg.attn_impl, remat=tcfg.remat, batch=T_BATCH, seq=T_SEQ,
         tokens_per_step=T_BATCH * T_SEQ, steps=T_STEPS, steps_done=steps_done,
         failure_at=FAIL_AT, ckpt_every=CKPT_EVERY, restarts=tstats.restarts,
         repartitions=tstats.repartitions,
         straggler_events=tstats.straggler_events,
         loss_first=loss_first, loss_last5_mean=loss_last5,
         losses=tstats.losses, step_ms_median=step_ms,
         step_ms_min=min(tstats.step_seconds) * 1e3,
         step_ms_max=max(tstats.step_seconds) * 1e3,
         tokens_per_s=T_BATCH * T_SEQ / (step_ms * 1e-3),
         wall_seconds=train_wall, memory_allocated_before=train_base,
         max_memory_allocated=train_peak,
         peak_memory_of_training=train_peak - train_base,
         launches={n: {"count": train_launches[n], "formula": f,
                       "expected": want}
                   for n, (f, want) in launch_formula.items()})

    # ---------------------------------------------------------------- grads
    gbatch = to_device(DataPipeline(SyntheticSource(tcfg.vocab_size, seed=SEED),
                                    T_BATCH, T_SEQ).batch_at(0), dev)
    gparams, _ = build_model(tcfg, dev).init(
        torch.Generator(device=dev).manual_seed(SEED))

    def loss_and_grads(**changes):
        model = build_model(tcfg.with_(**changes), dev)
        loss, grads = _accumulate_grads(model, gparams, gbatch, 1)
        flat = {f"layers/{k}": v for k, v in grads["layers"].items()}
        flat.update((k, v) for k, v in grads.items() if k != "layers")
        return float(loss), flat

    loss_k, grads_k = loss_and_grads()               # kernels, remat="layer"
    loss_e, grads_e = loss_and_grads(attn_impl="xla")
    loss_rel = abs(loss_k - loss_e) / abs(loss_e)
    leaf_rel = {n: rel_err(grads_k[n], grads_e[n]) for n in grads_e}
    # softmax is unchanged by adding one score to every key of a query, so
    # the key bias's gradient vanishes and both routes hold rounding noise
    # there: it is held to be small beside the query bias's instead
    bq_max = float(grads_e["layers/bq"].abs().max())
    bk_ratio = {route: float(g["layers/bk"].abs().max()) / bq_max
                for route, g in (("xla_cv", grads_k), ("xla", grads_e))}
    bad = {n: r for n, r in leaf_rel.items() if n != "layers/bk" and r >= MODEL_TOL}
    if (not np.isfinite(loss_k) or loss_rel >= 1e-2 or bad
            or max(bk_ratio.values()) >= MODEL_TOL):
        fail(f"grads: kernel vs eager loss rel {loss_rel:.3e}, leaves over "
             f"{MODEL_TOL}: {bad}, key-bias ratio {bk_ratio}")
    del grads_e
    remat_rows = {}
    for remat in ("none", "offload"):
        before = mtfm.offload_activation.d2h_bytes
        loss_r, grads_r = loss_and_grads(remat=remat)
        sent = mtfm.offload_activation.d2h_bytes - before
        worst = max(rel_err(grads_r[n], grads_k[n]) for n in grads_k)
        remat_rows[remat] = {"loss": loss_r,
                             "loss_rel": abs(loss_r - loss_k) / abs(loss_k),
                             "max_leaf_rel": worst, "host_bytes_per_step": sent}
        if remat_rows[remat]["loss_rel"] > 1e-6 or worst > 1e-6:
            fail(f"grads: remat={remat} differs from remat=layer: "
                 f"{remat_rows[remat]}")
        del grads_r
    want_host = L * T_BATCH * T_SEQ * tcfg.d_model * 2      # bf16 layer inputs
    if remat_rows["offload"]["host_bytes_per_step"] != want_host:
        fail(f"grads: the offload route sent "
             f"{remat_rows['offload']['host_bytes_per_step']} bytes to the host, "
             f"expected layers x batch x seq x d_model x 2 = {want_host}")
    emit("grads", arch=tcfg.name, batch=T_BATCH, seq=T_SEQ, loss_kernel=loss_k,
         loss_eager=loss_e, loss_rel=loss_rel, loss_tol=1e-2,
         leaf_rel=leaf_rel, leaf_tol=MODEL_TOL, key_bias_vs_query_bias=bk_ratio,
         remat_vs_layer=remat_rows, remat_tol=1e-6,
         offload_host_bytes_expected=want_host)
    del grads_k, gparams
    torch.cuda.empty_cache()

    # ------------------------------------- train_ssm, train_hybrid, train_moe
    def plain_routes(chunk):
        """The plain routes for one step: the SSD's forward by ssd_chunked at
        ``chunk`` (its backward is ssd_chunked at the model's chunk on every
        route); the expert products by grouped_matmul_plain."""
        def plain_ssd(x, dt, A, B_, C_, _, init_state=None):
            return mssm.ssd_chunked(x, dt, A, B_, C_, chunk,
                                    init_state=init_state)
        return {"ssd_kernel": plain_ssd,
                "grouped_matmul": gmm.grouped_matmul_plain}

    def step_grads(cfg, params, batch, routes=None):
        """Loss and flat gradients of one step; ``routes`` swaps the kernels
        for plain versions (and attention for the eager flash) meanwhile."""
        mods = {"ssd_kernel": mssm, "grouped_matmul": gmm}
        kept = {n: getattr(m, n) for n, m in mods.items()}
        try:
            for n, fn in (routes or {}).items():
                setattr(mods[n], n, fn)
            model = build_model(cfg.with_(attn_impl="xla") if routes else cfg,
                                dev)
            loss, grads = _accumulate_grads(model, params, batch, 1)
        finally:
            for n, fn in kept.items():
                setattr(mods[n], n, fn)
        return float(loss), dict(_flatten_with_paths(grads))

    def compare(a, b):
        rel = {n: rel_err(a[1][n], b[1][n]) for n in b[1]}
        worst = max(rel, key=rel.get)
        return {"loss_rel": abs(a[0] - b[0]) / abs(b[0]),
                "max_leaf_rel": rel[worst], "worst_leaf": worst,
                "leaves_over_tol": {n: r for n, r in rel.items()
                                    if not r < 1e-4}}

    def routes_vs_plain(cfg, spread=False):
        """One step's loss and gradients of ``cfg`` in fp32 activations
        (T_BATCH x T_SEQ tokens, random weights from SEED) through the
        kernels against the same step with the plain routes on the card: the
        SSD by ssd_chunked at the kernel's chunk (ssd_scan.CHUNK), the expert
        products by grouped_matmul_plain, attention by the eager chunked
        flash. With ``spread``, also the plain route against itself at the
        model's own chunk: how far two plain fp32 runs of the step part, the
        floor under any comparison of this model in fp32."""
        fcfg = cfg.with_(dtype="float32")
        params, _ = build_model(fcfg, dev).init(
            torch.Generator(device=dev).manual_seed(SEED))
        batch = to_device(DataPipeline(SyntheticSource(fcfg.vocab_size,
                                                       seed=SEED),
                                       T_BATCH, T_SEQ).batch_at(0), dev)
        kern = step_grads(fcfg, params, batch)
        plain = step_grads(fcfg, params, batch, plain_routes(ssd.CHUNK))
        out = {"layers": cfg.num_layers, "loss_kernel": kern[0],
               "loss_plain": plain[0], "kernel_vs_plain": compare(kern, plain)}
        if spread:
            if cfg.ssm_chunk == ssd.CHUNK:
                fail(f"{cfg.name}: the model's chunk is the kernel's; no "
                     f"second plain route to measure the spread with")
            other = step_grads(fcfg, params, batch, plain_routes(cfg.ssm_chunk))
            out["plain_vs_plain_at_model_chunk"] = compare(plain, other)
            out["model_chunk"] = cfg.ssm_chunk
        c = out["kernel_vs_plain"]
        out["ok"] = (bool(np.isfinite(kern[0])) and c["loss_rel"] < 1e-4
                     and not c["leaves_over_tol"])
        return out

    def family_grads_vs_plain(cfg, check_layers=None):
        """The kernel-vs-plain gradient check: each leaf within 1e-4 of its
        largest value (no leaf of these models has a gradient that is zero
        in exact arithmetic: none has a key bias, so no absolute floor).
        Held at full depth, or, where the full-depth model's own fp32
        spread (plain vs plain at the model's chunk) is not below 1e-4, at
        1e-4 at ``check_layers`` layers of the full width: at full depth the
        SSM families amplify fp32 rounding past 1e-4 (PERF.md). The
        full-depth reading is then held to twice that spread, measured in
        the same run: loss and worst leaf within max(1e-4, 2 x plain vs
        plain)."""
        full = routes_vs_plain(cfg, spread=bool(check_layers))
        out = {"rows": T_BATCH, "seq": T_SEQ, "dtype": "float32", "tol": 1e-4,
               "full_depth": full}
        if not check_layers:
            out["checked_at_layers"] = full["layers"]
            out["ok"] = full["ok"]
            return out
        c, spread = full["kernel_vs_plain"], full["plain_vs_plain_at_model_chunk"]
        limit = {k: max(1e-4, 2 * spread[k])
                 for k in ("loss_rel", "max_leaf_rel")}
        full["full_depth_limit"] = limit
        full["full_depth_ok"] = bool(np.isfinite(full["loss_kernel"])) and all(
            c[k] <= limit[k] for k in limit)
        checked = routes_vs_plain(cfg.with_(num_layers=check_layers))
        out["checked_at_layers"] = checked["layers"]
        out["checked"] = checked
        out["ok"] = checked["ok"] and full["full_depth_ok"]
        return out

    def train_family(phase, arch, steps, formula, check_layers=None, lr=3e-3):
        """``arch`` at full size trained through launch/train.py's path
        (FaultTolerantRunner, checkpoints; no failure injected): ``steps``
        AdamW steps of T_BATCH x T_SEQ tokens (peak lr ``lr``), bf16
        activations, fp32 parameters, attention through the flash kernels,
        remat "layer". The
        counts are set to 0 just before and read just after, and must equal
        ``formula(cfg)`` (per step) times the steps; every bf16 launch of a
        routed kernel takes the wgmma route."""
        cfg = build_config(arch, full_size=True, attn_impl="xla_cv",
                           remat="layer")
        gc.collect()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckpt_dir:
            reset_counts()                           # main path starts here
            t0 = time.perf_counter()
            st = run_training(cfg, steps=steps, batch=T_BATCH, seq=T_SEQ,
                              lr=lr, device=dev, ckpt_dir=ckpt_dir,
                              ckpt_every=steps + 1, seed=SEED)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {n: w.launches for n, w in kernel_wrappers.items()}
            routes = route_counts()
            transpose_bytes = gmm.grouped_matmul.transpose_bytes
        peak = torch.cuda.max_memory_allocated()
        if st.steps_done != steps or not all(np.isfinite(st.losses)):
            fail(f"{phase}: steps {st.steps_done} of {steps}, losses {st.losses}")
        first, last5 = st.losses[0], statistics.mean(st.losses[-5:])
        if first - last5 < 0.5:
            fail(f"{phase}: loss {first:.4f} -> {last5:.4f} fell less than "
                 f"0.5 nat")
        want = {n: (f, n_step * steps)
                for n, (f, n_step) in formula(cfg).items()}
        if launches != {n: c for n, (_, c) in want.items()}:
            fail(f"{phase}: launches {launches} != {want}")
        check_launches(f"{phase} routes", routes, {
            n: {r: (launches[n] if r == "wgmma" else 0) for r in routes[n]}
            for n in routes})
        if transpose_bytes:
            fail(f"{phase}: grouped_matmul copied {transpose_bytes} bytes of "
                 f"x^T; the wgmma dw reads x through its transposed A")
        grads = family_grads_vs_plain(cfg, check_layers)
        if not grads["ok"]:
            fail(f"{phase}: kernel vs plain-route gradients over their limit: "
                 f"{grads}")
        step_ms = statistics.median(st.step_seconds) * 1e3
        emit(phase, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
             vocab=cfg.vocab_size, params=cfg.param_count(),
             param_dtype=cfg.param_dtype, dtype=cfg.dtype,
             attn_impl=cfg.attn_impl, remat=cfg.remat, batch=T_BATCH, lr=lr,
             seq=T_SEQ, tokens_per_step=T_BATCH * T_SEQ, steps=steps,
             loss_first=first, loss_last5_mean=last5, losses=st.losses,
             step_ms_median=step_ms,
             step_ms_min=min(st.step_seconds) * 1e3,
             step_ms_max=max(st.step_seconds) * 1e3,
             tokens_per_s=T_BATCH * T_SEQ / (step_ms * 1e-3), card=card_line,
             wall_seconds=wall, memory_allocated_before=base,
             max_memory_allocated=peak, peak_memory_of_training=peak - base,
             launches={n: {"count": launches[n], "formula": f, "expected": c}
                       for n, (f, c) in want.items()},
             launches_by_route=routes,
             grouped_matmul_transpose_bytes=transpose_bytes,
             grads_vs_plain=grads)
        return launches, routes

    def no_launch(**nonzero):
        base = {n: ("0", 0) for n in kernel_wrappers}
        base.update(nonzero)
        return base

    def ssm_formula(cfg):
        # each layer wrapped alone: its forward and the backward's recompute;
        # the backward itself recomputes the plain ssd_chunked: no launch
        return no_launch(ssd_scan=("2 x layers a step", 2 * cfg.num_layers))

    def hybrid_formula(cfg):
        # a grouped SSM layer runs the forward, the group's recompute and its
        # own recompute inside that; a tail layer the forward and its
        # recompute; the shared block is checkpointed only with its group
        g = cfg.attn_every
        n_groups = cfg.num_layers // g
        tail = cfg.num_layers - n_groups * g
        return no_launch(
            ssd_scan=("3 x grouped layers + 2 x tail layers a step",
                      3 * n_groups * g + 2 * tail),
            flash_attention_fwd_stats=("2 x groups a step", 2 * n_groups),
            flash_attention_bwd_dkdv=("groups a step", n_groups),
            flash_attention_bwd_dq=("groups a step", n_groups))

    def dense_formula(cfg):
        # per layer: the forward, the backward's recompute, one backward
        L = cfg.num_layers
        return no_launch(
            flash_attention_fwd_stats=("2 x layers a step", 2 * L),
            flash_attention_bwd_dkdv=("layers a step", L),
            flash_attention_bwd_dq=("layers a step", L))

    def moe_formula(cfg):
        # per layer: 3 expert products forward, 3 recomputed, and dx, dw of
        # each in the backward
        L = cfg.num_layers
        return no_launch(
            grouped_matmul=("12 x layers a step", 12 * L),
            flash_attention_fwd_stats=("2 x layers a step", 2 * L),
            flash_attention_bwd_dkdv=("layers a step", L),
            flash_attention_bwd_dq=("layers a step", L))

    # steps: each loss falls well past 0.5 nat by then (the warm-up is 20
    # steps, so the first steps' rates do not depend on the count); the
    # SSM families' gradient check at full width and 4 layers (mamba2), one
    # group, the shared block and the 2 tail layers (zamba2)
    tssm_launches, _ = train_family("train_ssm", "mamba2-130m", 8, ssm_formula,
                                    check_layers=4)
    thyb_launches, _ = train_family("train_hybrid", "zamba2-1.2b", 12,
                                    hybrid_formula, check_layers=8)
    tmoe_launches, tmoe_routes = train_family("train_moe", "granite-moe-1b-a400m",
                                              8, moe_formula)
    # phi3-mini-3.8b: the flash forward+lse and backward kernels at head dim
    # 96 on a training path; the gradient check at full depth (its two fp32
    # routes agree to ~1e-6 there). Its fp32 parameters, gradients and AdamW
    # moments take 61.1 GB before any activation; at T_BATCH x T_SEQ the
    # step peaks under the card's memory (PERF.md §6). The runner warms the
    # lr up linearly over 20 steps, so these 8 steps run at 1/20 to 8/20 of
    # the peak: 1.5e-6 to 1.2e-5 at this peak of 3e-5. A sweep of peaks
    # through launch/train.py on the card (PERF.md §6) reads the loss rising
    # at 3e-3 and 1e-3, falling less than the 0.5-nat gate at 3e-4, and
    # passing it at 1e-4 and 3e-5
    tphi_launches, tphi_routes = train_family(
        "train_phi3", "phi3-mini-3.8b", 8, dense_formula, lr=3e-5)
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ ssm
    def param_count(params):
        return sum(t.numel() for t in tree_leaves(params))

    def ssm_param_count(cfg):
        """The config's analytic count (the reference's formula) leaves out
        the per-head ``D_skip`` of every Mamba2 layer, which both packages'
        init create."""
        return cfg.param_count() + cfg.num_layers * cfg.ssm_heads

    scfg = get_config("mamba2-130m").with_(remat="none", param_dtype="bfloat16")
    smodel = build_model(scfg, dev)
    t0 = time.time()
    sparams, _ = smodel.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    s_init = time.time() - t0
    if param_count(sparams) != ssm_param_count(scfg):
        fail(f"mamba2: parameter count {param_count(sparams)} != "
             f"{ssm_param_count(scfg)}")
    run_engine(ServingEngine(smodel, sparams, slots=SLOTS, max_seq=MAX_SEQ),
               make_requests(scfg, LENS, 2))                   # warm-up
    seng = timed_engine(ServingEngine(smodel, sparams, slots=SLOTS,
                                      max_seq=MAX_SEQ))
    sreqs = make_requests(scfg, LENS, MAX_NEW)
    reset_counts()                                   # main path starts here
    sout, swall = run_engine(seng, sreqs)
    ssm_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    check_outputs(sout, sreqs, scfg, MAX_NEW)
    if seng.stats.admitted != len(LENS):
        fail(f"mamba2: admitted {seng.stats.admitted} of {len(LENS)}")
    check_launches("ssm", ssm_launches, {
        **{n: 0 for n in kernel_wrappers},
        "ssd_scan": len(LENS) * scfg.num_layers})      # 8 prefills x 24 layers
    stokens = sum(len(v) for v in sout.values())
    s_pool = seng.pool
    pool_dtypes = {p: str(t.dtype) for p, t in
                   _flatten_with_paths(s_pool.materialize())}

    # prefill 300 tokens, decode the 301st: equals the full forward's last
    # row (the kernel's prefill against the plain recurrence of decode)
    rng = np.random.default_rng(SEED + 2)
    stoks = torch.as_tensor(rng.integers(0, scfg.vocab_size, size=(1, 301)),
                            device=dev)
    s_full, _, _ = smodel.forward(sparams, {"tokens": stoks})
    _, _, spc = smodel.forward(sparams, {"tokens": stoks[:, :300]},
                               return_cache=True)
    scache = smodel.init_cache(1, 512)
    for (_, dst), (_, src) in zip(_flatten_with_paths(scache),
                                  _flatten_with_paths(spc)):
        dst.copy_(src)
    s_dec, _ = smodel.decode(sparams, scache, {
        "tokens": stoks[:, 300:301], "pos": torch.tensor(300, device=dev)})
    torch.cuda.synchronize()
    if tuple(s_full.shape) != (1, 301, scfg.vocab_size) or not (
            torch.isfinite(s_full.float()).all()
            and torch.isfinite(s_dec.float()).all()):
        fail("mamba2: non-finite or misshapen logits")
    s_decode_vs_forward = rel_err(s_dec[0], s_full[0, -1])
    # how far bf16's roundings move this random-init model: the same weights
    # with fp32 activations (data, not a check)
    s_full32, _, _ = build_model(scfg.with_(dtype="float32"), dev).forward(
        sparams, {"tokens": stoks})
    s_bf16_vs_fp32 = rel_err(s_full, s_full32)
    s_argmax_agree = float((s_full.argmax(-1) == s_full32.argmax(-1)).float().mean())
    del s_full32
    # one full-width layer: the kernel's route against the same layer with
    # the plain ssd_chunked called in its place
    lp = {k: v[0] for k, v in sparams["layers"].items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    u = torch.randn(1, 1024, scfg.d_model, device=dev, generator=g).bfloat16()
    y_k, c_k = mssm.apply_ssm(scfg, lp, u, mssm.init_ssm_cache(
        scfg, 1, u.dtype, dev))
    kernel_prefill = mssm._ssd_prefill
    mssm._ssd_prefill = lambda cfg, xh, dt, A, B_, C_, s0: mssm.ssd_chunked(
        xh, dt, A, B_, C_, cfg.ssm_chunk, init_state=s0)
    try:
        y_p, c_p = mssm.apply_ssm(scfg, lp, u, mssm.init_ssm_cache(
            scfg, 1, u.dtype, dev))
    finally:
        mssm._ssd_prefill = kernel_prefill
    torch.cuda.synchronize()
    layer_rel, layer_state_rel = rel_err(y_k, y_p), rel_err(c_k.state, c_p.state)
    if (s_decode_vs_forward >= MODEL_TOL or layer_rel >= SSD_TOL["bfloat16"]
            or layer_state_rel >= SSD_STATE_TOL):
        fail(f"mamba2: decode vs forward {s_decode_vs_forward:.3e} (limit "
             f"{MODEL_TOL}), layer through the kernel vs ssd_chunked "
             f"{layer_rel:.3e} (limit {SSD_TOL['bfloat16']}), its state "
             f"{layer_state_rel:.3e} (limit {SSD_STATE_TOL})")
    # the same requests with the pool fully in pinned host memory
    heng = timed_engine(TenantEngine(smodel, sparams, slots=SLOTS,
                                     max_seq=MAX_SEQ, offload_kv=True))
    hout, hwall = run_engine(heng, make_requests(scfg, LENS, MAX_NEW))
    if hout != sout:
        fail("mamba2: tokens with the pool in pinned host memory differ")
    h_pool = heng.pool
    host_dtypes = [str(t.dtype) for t in h_pool.host_tensors()]
    if (h_pool.memory_kinds() != {"pinned_host"}
            or not all(t.is_pinned() for t in h_pool.host_tensors())
            or host_dtypes != ["torch.bfloat16", "torch.float32"]
            or pool_dtypes != {"ssm/.conv": "torch.bfloat16",
                               "ssm/.state": "torch.float32"}):
        fail(f"mamba2 pools: device leaves {pool_dtypes}, host leaves "
             f"{host_dtypes} in {h_pool.memory_kinds()}")
    emit("ssm", arch=scfg.name, layers=scfg.num_layers, d_model=scfg.d_model,
         d_inner=scfg.d_inner, heads=scfg.ssm_heads, head_dim=scfg.ssm_head_dim,
         state=scfg.ssm_state, vocab=scfg.vocab_size,
         params=param_count(sparams), param_dtype=scfg.param_dtype,
         init_seconds=s_init, requests=len(sout), prompt_lens=LENS,
         slots=SLOTS, max_seq=MAX_SEQ, tokens=stokens, ticks=seng.ticks,
         admitted=seng.stats.admitted, wall_seconds=swall,
         tok_per_s=stokens / swall,
         prefill_ms={str(n): t * 1e3 for n, t in seng.prefill_s},
         prefill_ms_median=statistics.median(t for _, t in seng.prefill_s) * 1e3,
         tick_ms_median=statistics.median(seng.tick_s) * 1e3,
         launches=ssm_launches, pool_bytes=smodel.cache_bytes(SLOTS, MAX_SEQ),
         pool_dtypes=pool_dtypes, decode_vs_forward_rel=s_decode_vs_forward,
         bf16_vs_fp32_logits_rel=s_bf16_vs_fp32,
         bf16_vs_fp32_argmax_agree=s_argmax_agree,
         tol=MODEL_TOL, layer_kernel_vs_ssd_chunked_rel=layer_rel,
         layer_state_rel=layer_state_rel,
         pinned_pool={"tokens_equal": True, "host_leaf_dtypes": host_dtypes,
                      "wall_seconds": hwall,
                      "tick_ms_median": statistics.median(heng.tick_s) * 1e3,
                      "h2d_bytes_per_tick": h_pool.h2d_bytes / max(heng.ticks, 1),
                      "d2h_bytes_per_tick": h_pool.d2h_bytes / max(heng.ticks, 1)})
    del smodel, sparams, seng, heng, s_pool, h_pool, scache, spc, s_full
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- hybrid
    zcfg = get_config("zamba2-1.2b").with_(attn_impl="pallas", remat="none",
                                           param_dtype="bfloat16")
    zmeta = build_model(zcfg, dev)
    zinv = zmeta.serving_inventory(zmeta.init(abstract=True)[0],
                                   zmeta.cache_shapes(SLOTS, MAX_SEQ))
    z_footprint = sum(t.bytes for t in zinv)
    z_embed = sum(t.bytes for t in zinv if t.group == "embed")
    z_kv = sum(t.bytes for t in zinv if t.group == "kv_cache")
    # one byte over what spilling the table and the KV and state pools frees:
    # by the planner's order the next spill is the largest stacked matrix
    z_budget = z_footprint - z_embed - z_kv - 1
    rt = SliceRuntime(device=dev)
    t0 = time.time()
    zt = rt.add_tenant(TenantSpec("hybrid", zcfg, profile="1s.16c",
                                  slots=SLOTS, max_seq=MAX_SEQ,
                                  hbm_budget=z_budget, seed=SEED))
    torch.cuda.synchronize()
    z_add_s = time.time() - t0
    zplan = zt.plan
    if param_count(zt.params) != ssm_param_count(zcfg):
        fail(f"zamba2: parameter count {param_count(zt.params)} != "
             f"{ssm_param_count(zcfg)}")
    z_streamed = [n for n in zplan.offloaded if n.startswith("params/layers/")]
    want_spilled = {"kv/k", "kv/v", "kv/ssm/.state"}
    if (not want_spilled <= set(zplan.offloaded) or len(z_streamed) != 1
            or z_streamed[0] not in ("params/layers/in_zx",
                                     "params/layers/out_proj")):
        fail(f"zamba2 plan spills {zplan.offloaded} {zplan.partial}; expected "
             f"{sorted(want_spilled)} and one stacked SSM projection")
    z_leaf = zt.params["layers"][z_streamed[0].split("/")[-1]]
    if memory_kind_of(z_leaf) != "pinned_host" or not z_leaf.is_pinned():
        fail(f"{z_streamed[0]} is not in pinned host memory after placement")
    if zt.engine.pool.memory_kinds() != {"pinned_host"}:
        fail(f"zamba2 pool kinds {zt.engine.pool.memory_kinds()}")
    table_streamed = zplan.is_offloaded("params/tok_embed")
    timed_engine(zt.engine)
    zreqs = make_requests(zcfg, LENS, MAX_NEW)
    rt.submit("hybrid", zreqs)
    reset_counts()                                   # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zreport = rt.run()
    torch.cuda.synchronize()
    z_wall = time.perf_counter() - t0
    z_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    z_stream_routes = dict(sm.stream_matmul.launches_by_route)
    z_h2d = sm.stream_matmul.h2d_bytes
    check_outputs(zt.engine.outputs, zreqs, zcfg, MAX_NEW)
    zst = zt.engine.stats
    n_groups = zcfg.num_layers // zcfg.attn_every
    # per prefill and tick: the streamed matrix in every layer, and the tied
    # unembedding when the plan spilled the table
    per_pass = zcfg.num_layers + int(table_streamed)
    check_launches("hybrid", z_launches, {
        **{n: 0 for n in kernel_wrappers},
        "ssd_scan": zst.admitted * zcfg.num_layers,
        "flash_attention_fwd": zst.admitted * n_groups,
        "stream_matmul": (zst.admitted + zst.ticks) * per_pass})
    check_launches("hybrid stream_matmul routes", z_stream_routes,
                   planned_stream_routes(zt.engine, per_pass))
    z_slice = z_leaf[0].numel() * z_leaf.element_size()
    table_bytes = (zt.params["tok_embed"].numel()
                   * zt.params["tok_embed"].element_size())
    per_tick_bytes = zcfg.num_layers * z_slice + table_bytes * table_streamed
    if z_h2d != (zst.admitted + zst.ticks) * per_tick_bytes:
        fail(f"zamba2: stream_matmul moved {z_h2d} bytes, expected "
             f"(prefills + ticks) x {per_tick_bytes}")
    # the same requests through a lone engine on the same placement, and
    # through one with every parameter on the device
    lone = TenantEngine(zt.model, zt.params, slots=SLOTS, max_seq=MAX_SEQ,
                        plan=zplan)
    lone_out, _ = run_engine(lone, make_requests(zcfg, LENS, MAX_NEW))
    if lone_out != zt.engine.outputs:
        fail("zamba2: runtime tokens differ from a lone engine's on the same "
             "placement")
    del lone
    z_on_device = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                       if isinstance(v, dict) else v.to(dev))
                   for k, v in zt.params.items()}
    ztoks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, zcfg.vocab_size, size=(1, 301)), device=dev)
    logits_h, _, _ = zt.model.forward(zt.params, {"tokens": ztoks})
    logits_d16, _, _ = zt.model.forward(z_on_device, {"tokens": ztoks})
    z_bf16_placed_vs_device = rel_err(logits_h, logits_d16)
    # the placement against every weight on the device, in fp32 activations
    # (the same bf16 weights): at random init the bf16 model's own roundings
    # move its logits by a fifth or more of their largest value (PERF.md), so
    # only fp32 can hold the placement to identical tokens
    z32 = build_model(zcfg.with_(dtype="float32"), dev)
    logits_h, _, _ = z32.forward(zt.params, {"tokens": ztoks})
    logits_d, _, _ = z32.forward(z_on_device, {"tokens": ztoks})
    torch.cuda.synchronize()
    z_placed_vs_device = rel_err(logits_h, logits_d)
    z_bf16_vs_fp32 = rel_err(logits_d16, logits_d)
    z_argmax_agree = float((logits_d16.argmax(-1) == logits_d.argmax(-1)).float().mean())
    if (not torch.isfinite(logits_h).all()
            or z_placed_vs_device >= FP32_MODEL_TOL):
        fail(f"zamba2 host-placed vs device logits (fp32): rel "
             f"{z_placed_vs_device:.3e} (limit {FP32_MODEL_TOL})")
    def fp32_engine(params, plan):
        """An engine in fp32 activations over an fp32 pool: a bf16 pool would
        round the two routes' caches to neighbouring bf16 values, which this
        random-init model amplifies into other tokens."""
        eng = TenantEngine(z32, params, slots=SLOTS, max_seq=MAX_SEQ, plan=plan)
        eng.pool = KVPool(z32, SLOTS, MAX_SEQ, plan=plan, dtype=torch.float32)
        return timed_engine(eng)

    placed32 = fp32_engine(zt.params, zplan)
    placed32_out, _ = run_engine(placed32, make_requests(zcfg, LENS, MAX_NEW))
    resident = fp32_engine(z_on_device, None)
    res_out, res_wall = run_engine(resident, make_requests(zcfg, LENS, MAX_NEW))
    res_agree = (sum(a == b for r in res_out
                     for a, b in zip(res_out[r], placed32_out[r]))
                 / sum(len(v) for v in res_out.values()))
    zrow = zreport["tenants"]["hybrid"]
    emit("hybrid", arch=zcfg.name, layers=zcfg.num_layers,
         attn_every=zcfg.attn_every, shared_applications=n_groups,
         d_model=zcfg.d_model, heads=zcfg.ssm_heads, state=zcfg.ssm_state,
         shared_heads=zcfg.num_heads, shared_head_dim=zcfg.head_dim,
         shared_d_ff=zcfg.d_ff, vocab=zcfg.vocab_size,
         params=param_count(zt.params), param_dtype=zcfg.param_dtype,
         attn_impl=zcfg.attn_impl, profile=zrow["profile"],
         footprint=z_footprint, hbm_budget=z_budget,
         plan={"offloaded": list(zplan.offloaded), "partial": list(zplan.partial),
               "resident_bytes": zplan.resident_bytes,
               "host_bytes": zplan.host_bytes},
         add_tenant_seconds=z_add_s, wall_seconds=z_wall,
         tokens=zrow["tokens_out"], tok_per_s=zrow["tok_per_s"],
         prefills=zst.admitted, ticks=zst.ticks,
         tick_ms_median=statistics.median(zt.engine.tick_s) * 1e3,
         prefill_ms_median=statistics.median(
             t for _, t in zt.engine.prefill_s) * 1e3,
         launches=z_launches, stream_matmul_launches_by_route=z_stream_routes,
         weight_h2d_bytes=z_h2d,
         weight_h2d_bytes_per_tick=per_tick_bytes,
         kv_host_bytes=zt.engine.pool.host_bytes,
         lone_tokens_equal=True,
         fp32_activations={
             "placed_vs_device_rel": z_placed_vs_device, "tol": FP32_MODEL_TOL,
             "device_resident_tokens_equal": res_out == placed32_out,
             "device_resident_token_agreement": res_agree,
             "placed_tick_ms_median": statistics.median(placed32.tick_s) * 1e3,
             "device_resident_tick_ms_median":
                 statistics.median(resident.tick_s) * 1e3,
             "device_resident_wall_seconds": res_wall},
         bf16_placed_vs_device_rel=z_bf16_placed_vs_device,
         bf16_vs_fp32_logits_rel=z_bf16_vs_fp32,
         bf16_vs_fp32_argmax_agree=z_argmax_agree)
    if res_out != placed32_out:
        fail(f"zamba2 (fp32): tokens with the plan's placement differ from "
             f"the device-resident engine's (agreement {res_agree:.3f})")
    rt.remove_tenant("hybrid")
    del rt, zt, z32, placed32, resident, z_on_device, z_leaf, logits_h, logits_d
    del logits_d16
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------ moe
    mcfg = get_config("granite-moe-1b-a400m").with_(
        attn_impl="pallas", remat="none", param_dtype="bfloat16")
    E, TOPK = mcfg.num_experts, mcfg.experts_per_token
    mmodel = build_model(mcfg, dev)
    t0 = time.time()
    mparams, _ = mmodel.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    m_init = time.time() - t0
    if param_count(mparams) != mcfg.param_count():
        fail(f"granite-moe: parameter count {param_count(mparams)} != "
             f"{mcfg.param_count()}")
    run_engine(ServingEngine(mmodel, mparams, slots=SLOTS, max_seq=MAX_SEQ),
               make_requests(mcfg, LENS, 2))                   # warm-up
    meng = timed_engine(ServingEngine(mmodel, mparams, slots=SLOTS,
                                      max_seq=MAX_SEQ))
    mreqs = make_requests(mcfg, LENS, MAX_NEW)
    reset_counts()                                   # main path starts here
    mout, mwall = run_engine(meng, mreqs)
    moe_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    moe_routes = route_counts()
    check_outputs(mout, mreqs, mcfg, MAX_NEW)
    mst = meng.stats
    # per layer: w_in, w_gate, w_out in every prefill and every tick
    check_launches("moe", moe_launches, {
        **{n: 0 for n in kernel_wrappers},
        "flash_attention_fwd": mst.admitted * mcfg.num_layers,
        "grouped_matmul": 3 * (mst.admitted + mst.ticks) * mcfg.num_layers})
    # every bf16 expert product (decode, prefill) on the wgmma route, every
    # bf16 attention prefill on the wgmma flash kernel
    check_launches("moe routes", moe_routes, {
        "flash_attention_fwd": {"wgmma": moe_launches["flash_attention_fwd"],
                                "fma": 0},
        "flash_attention_fwd_stats": {"wgmma": 0, "fma": 0},
        "flash_attention_bwd_dkdv": {"wgmma": 0, "fma": 0},
        "flash_attention_bwd_dq": {"wgmma": 0, "fma": 0},
        "grouped_matmul": {"wgmma": moe_launches["grouped_matmul"],
                           "mma_sync": 0, "fma": 0}})
    mtokens = sum(len(v) for v in mout.values())

    # capacity and drops of one 1024-token prefill: the share of the
    # top-k assignments that find their expert's buffer full, per layer
    dropped = []
    slots_fn = mmoe._slots

    def counting_slots(cfg, top_w, top_e, C):
        slot_token, keep_w, slot = slots_fn(cfg, top_w, top_e, C)
        dropped.append(float((slot == cfg.num_experts * C).float().mean()))
        return slot_token, keep_w, slot

    rng = np.random.default_rng(SEED + 4)
    mtoks = torch.as_tensor(rng.integers(0, mcfg.vocab_size, size=(1, 1024)),
                            device=dev)
    mmoe._slots = counting_slots
    try:
        mmodel.forward(mparams, {"tokens": mtoks})
    finally:
        mmoe._slots = slots_fn
    torch.cuda.synchronize()
    cap_1024 = mmoe.capacity(mcfg, 1024)

    # prefill 300 tokens, decode the 301st against the full forward's last
    # row. The decode computes every expert densely and drops nothing, so
    # the forward runs at the least capacity factor that drops nothing
    # (C >= S: experts / top-k); fp32 activations hold it (bf16 is data: a
    # rounding can flip a routing decision)
    no_drop = E / TOPK
    m_rows = {}
    for act_dtype in ("float32", "bfloat16"):
        dmodel = build_model(mcfg.with_(capacity_factor=no_drop, dtype=act_dtype), dev)
        full, _, _ = dmodel.forward(mparams, {"tokens": mtoks[:, :301]})
        _, _, pc = dmodel.forward(mparams, {"tokens": mtoks[:, :300]},
                                  return_cache=True)
        cache = dmodel.init_cache(1, 512, getattr(torch, act_dtype))
        for name in cache:
            cache[name][:, :, :300] = pc[name].to(cache[name].dtype)
        dec, _ = dmodel.decode(mparams, cache, {
            "tokens": mtoks[:, 300:301], "pos": torch.tensor(300, device=dev)})
        torch.cuda.synchronize()
        if not (torch.isfinite(full.float()).all() and torch.isfinite(dec.float()).all()):
            fail(f"granite-moe: non-finite logits ({act_dtype})")
        m_rows[act_dtype] = rel_err(dec[0], full[0, -1])
        del full, pc, cache, dec
    if m_rows["float32"] >= FP32_MODEL_TOL:
        fail(f"granite-moe decode vs forward (fp32): rel {m_rows['float32']:.3e} "
             f"(limit {FP32_MODEL_TOL})")
    emit("moe", arch=mcfg.name, layers=mcfg.num_layers, d_model=mcfg.d_model,
         experts=E, top_k=TOPK, d_ff=mcfg.d_ff, vocab=mcfg.vocab_size,
         params=param_count(mparams), param_dtype=mcfg.param_dtype,
         attn_impl=mcfg.attn_impl, init_seconds=m_init, requests=len(mout),
         prompt_lens=LENS, slots=SLOTS, max_seq=MAX_SEQ, tokens=mtokens,
         ticks=meng.ticks, admitted=mst.admitted, wall_seconds=mwall,
         tok_per_s=mtokens / mwall,
         prefill_ms={str(n): t * 1e3 for n, t in meng.prefill_s},
         prefill_ms_median=statistics.median(t for _, t in meng.prefill_s) * 1e3,
         tick_ms_median=statistics.median(meng.tick_s) * 1e3,
         launches=moe_launches, launches_by_route=moe_routes, kv_pool_bytes=mmodel.cache_bytes(SLOTS, MAX_SEQ),
         capacity_factor=mcfg.capacity_factor, capacity_1024=cap_1024,
         assignments_1024=1024 * TOPK,
         dropped_share_1024_by_layer=dropped,
         dropped_share_1024_mean=statistics.mean(dropped),
         no_drop_capacity_factor=no_drop,
         decode_vs_forward_fp32_rel=m_rows["float32"], tol=FP32_MODEL_TOL,
         decode_vs_forward_bf16_rel=m_rows["bfloat16"])
    del mmodel, mparams, meng
    gc.collect()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- moe_runtime
    mmeta = build_model(mcfg, dev)
    minv = mmeta.serving_inventory(mmeta.init(abstract=True)[0],
                                   mmeta.cache_shapes(SLOTS, MAX_SEQ))
    m_footprint = sum(t.bytes for t in minv)
    m_embed = sum(t.bytes for t in minv if t.group == "embed")
    m_kv = sum(t.bytes for t in minv if t.group == "kv_cache")
    # one byte over what spilling the table and the KV pool frees: by the
    # planner's order the next spill is one whole expert stack
    m_budget = m_footprint - m_embed - m_kv - 1
    rt = SliceRuntime(device=dev)
    t0 = time.time()
    mt = rt.add_tenant(TenantSpec("moe", mcfg, profile="1s.16c", slots=SLOTS,
                                  max_seq=MAX_SEQ, hbm_budget=m_budget,
                                  seed=SEED))
    torch.cuda.synchronize()
    m_add_s = time.time() - t0
    mplan = mt.plan
    experts_spilled = [n for n in mplan.offloaded if n in (
        "params/layers/w_in", "params/layers/w_gate", "params/layers/w_out")]
    if len(experts_spilled) != 1:
        fail(f"granite-moe plan spills {mplan.offloaded} {mplan.partial}; "
             f"expected one expert stack")
    m_leaf = mt.params["layers"][experts_spilled[0].split("/")[-1]]
    if (memory_kind_of(m_leaf) != "pinned_host" or not m_leaf.is_pinned()
            or not m_leaf[0].is_pinned()):
        fail(f"{experts_spilled[0]} (or its layer slice) is not in pinned host "
             f"memory after placement")
    m_table_streamed = mplan.is_offloaded("params/tok_embed")
    timed_engine(mt.engine)
    rt_reqs = make_requests(mcfg, LENS, MAX_NEW)
    rt.submit("moe", rt_reqs)
    reset_counts()                                   # main path starts here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mreport = rt.run()
    torch.cuda.synchronize()
    m_wall = time.perf_counter() - t0
    mrt_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    mrt_routes = route_counts()
    mrt_stream_routes = dict(sm.stream_matmul.launches_by_route)
    m_h2d = gmm.grouped_matmul.h2d_bytes
    check_outputs(mt.engine.outputs, rt_reqs, mcfg, MAX_NEW)
    mrs = mt.engine.stats
    passes = mrs.admitted + mrs.ticks
    check_launches("moe_runtime", mrt_launches, {
        **{n: 0 for n in kernel_wrappers},
        "flash_attention_fwd": mrs.admitted * mcfg.num_layers,
        "grouped_matmul": 3 * passes * mcfg.num_layers,
        # the tied unembedding reads the spilled table once a pass
        "stream_matmul": passes * int(m_table_streamed)})
    # the streamed w_gate's panels too
    check_launches("moe_runtime routes", mrt_routes, {
        "flash_attention_fwd": {"wgmma": mrt_launches["flash_attention_fwd"],
                                "fma": 0},
        "flash_attention_fwd_stats": {"wgmma": 0, "fma": 0},
        "flash_attention_bwd_dkdv": {"wgmma": 0, "fma": 0},
        "flash_attention_bwd_dq": {"wgmma": 0, "fma": 0},
        "grouped_matmul": {"wgmma": mrt_launches["grouped_matmul"],
                           "mma_sync": 0, "fma": 0}})
    check_launches("moe_runtime stream_matmul routes", mrt_stream_routes,
                   planned_stream_routes(mt.engine, int(m_table_streamed)))
    per_pass = mcfg.num_layers * m_leaf[0].numel() * m_leaf.element_size()
    if m_h2d != passes * per_pass:
        fail(f"granite-moe: grouped_matmul streamed {m_h2d} bytes, expected "
             f"(prefills + ticks) x {per_pass}")
    lone = TenantEngine(mt.model, mt.params, slots=SLOTS, max_seq=MAX_SEQ,
                        plan=mplan)
    lone_out, _ = run_engine(lone, make_requests(mcfg, LENS, MAX_NEW))
    if lone_out != mt.engine.outputs:
        fail("granite-moe: runtime tokens differ from a lone engine's on the "
             "same placement")
    del lone
    m_on_device = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                       if isinstance(v, dict) else v.to(dev))
                   for k, v in mt.params.items()}
    mtoks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, mcfg.vocab_size, size=(1, 301)), device=dev)
    logits_h, _, _ = mt.model.forward(mt.params, {"tokens": mtoks})
    logits_d, _, _ = mt.model.forward(m_on_device, {"tokens": mtoks})
    torch.cuda.synchronize()
    m_bf16_placed_vs_device = rel_err(logits_h, logits_d)
    if (not torch.isfinite(logits_h.float()).all()
            or m_bf16_placed_vs_device >= MODEL_TOL):
        fail(f"granite-moe host-placed vs device logits (bf16): rel "
             f"{m_bf16_placed_vs_device:.3e} (limit {MODEL_TOL})")
    del logits_h, logits_d
    m32 = build_model(mcfg.with_(dtype="float32"), dev)

    def moe_fp32_engine(params, plan):
        eng = TenantEngine(m32, params, slots=SLOTS, max_seq=MAX_SEQ, plan=plan)
        eng.pool = KVPool(m32, SLOTS, MAX_SEQ, plan=plan, dtype=torch.float32)
        return timed_engine(eng)

    m_placed32 = moe_fp32_engine(mt.params, mplan)
    m_placed32_out, _ = run_engine(m_placed32, make_requests(mcfg, LENS, MAX_NEW))
    m_res32 = moe_fp32_engine(m_on_device, None)
    m_res32_out, m_res_wall = run_engine(m_res32, make_requests(mcfg, LENS, MAX_NEW))
    m_agree = (sum(a == b for r in m_res32_out
                   for a, b in zip(m_res32_out[r], m_placed32_out[r]))
               / sum(len(v) for v in m_res32_out.values()))
    mrow = mreport["tenants"]["moe"]
    emit("moe_runtime", arch=mcfg.name, profile=mrow["profile"],
         footprint=m_footprint, hbm_budget=m_budget,
         plan={"offloaded": list(mplan.offloaded), "partial": list(mplan.partial),
               "resident_bytes": mplan.resident_bytes,
               "host_bytes": mplan.host_bytes},
         add_tenant_seconds=m_add_s, wall_seconds=m_wall,
         tokens=mrow["tokens_out"], tok_per_s=mrow["tok_per_s"],
         prefills=mrs.admitted, ticks=mrs.ticks,
         tick_ms_median=statistics.median(mt.engine.tick_s) * 1e3,
         prefill_ms_median=statistics.median(t for _, t in mt.engine.prefill_s) * 1e3,
         launches=mrt_launches, launches_by_route=mrt_routes,
         stream_matmul_launches_by_route=mrt_stream_routes,
         expert_h2d_bytes=m_h2d,
         expert_h2d_bytes_per_pass=per_pass, table_streamed=m_table_streamed,
         kv_host_bytes=mt.engine.pool.host_bytes, lone_tokens_equal=True,
         fp32_activations={
             "device_resident_tokens_equal": m_res32_out == m_placed32_out,
             "device_resident_token_agreement": m_agree,
             "placed_tick_ms_median": statistics.median(m_placed32.tick_s) * 1e3,
             "device_resident_tick_ms_median":
                 statistics.median(m_res32.tick_s) * 1e3,
             "device_resident_wall_seconds": m_res_wall},
         bf16_placed_vs_device_rel=m_bf16_placed_vs_device, tol=MODEL_TOL)
    if m_res32_out != m_placed32_out:
        fail(f"granite-moe (fp32): tokens with the plan's placement differ "
             f"from the device-resident engine's (agreement {m_agree:.3f})")
    rt.remove_tenant("moe")
    del rt, mt, m32, m_placed32, m_res32, m_on_device, m_leaf
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------------- encdec and vlm
    def pool_serve(model, params, prompts, step_inputs, max_new, slots,
                   max_seq, plan=None, dtype=torch.bfloat16):
        """Serve ``prompts`` (batches of one request each) through a KVPool
        of ``slots`` x ``max_seq`` in ``dtype`` placed by ``plan`` (on the
        card when None): each request prefilled alone
        (``Model.forward(return_cache=True, last_token_only=True)``) and
        pasted into its slot, then all slots decoded together, greedy, with
        per-row ``pos`` (the pool's lengths). ``step_inputs(rows, tokens)``
        gives a decode step's inputs for the requests in ``rows`` (one a
        slot) and their last tokens. Returns the tokens by request, the
        prefill and tick seconds, the first tick's logits by request, the
        wall time, a function that runs one more tick, and the pool."""
        pool = KVPool(model, slots, max_seq, plan=plan, dtype=dtype)
        rows, out, prefill_s, tick_s = [None] * slots, {}, [], []
        torch.cuda.synchronize()
        t_wall = time.perf_counter()
        for rid, batch in enumerate(prompts):
            t = time.perf_counter()
            logits, _, pc = model.forward(params, batch, return_cache=True,
                                          last_token_only=True)
            slot = pool.alloc_slot()
            plen = (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]
            pool.paste(slot, pc, plen)
            rows[slot] = rid
            out[rid] = [int(logits[0, -1].argmax())]
            torch.cuda.synchronize()
            prefill_s.append((plen, time.perf_counter() - t))

        def tick():
            last = torch.tensor([[out[r][-1]] for r in rows], device=dev)
            batch = {**step_inputs(rows, last),
                     "pos": torch.as_tensor(pool.positions, device=dev)}
            logits, cache = model.decode(params, pool.materialize(), batch)
            pool.update(cache)
            pool.positions += 1
            return logits

        first = {}
        for _ in range(max_new - 1):
            t = time.perf_counter()
            logits = tick()
            nxt = logits.argmax(-1).tolist()
            for slot, rid in enumerate(rows):
                out[rid].append(nxt[slot])
            if not first:
                first = {rid: logits[slot] for slot, rid in enumerate(rows)}
            torch.cuda.synchronize()
            tick_s.append(time.perf_counter() - t)
        wall = time.perf_counter() - t_wall
        return out, prefill_s, tick_s, first, wall, tick, pool

    def device_profile(fn, calls, unit):
        """``calls`` calls of ``fn`` under torch.profiler: per call the wall
        and device-busy ms, the idle share, device ops, the top ops."""
        from torch.profiler import ProfilerActivity, profile as torch_profile
        torch.cuda.synchronize()
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        return device_summary(prof, wall, calls, top=8, unit=unit)

    def check_pool_outputs(name, out, n_req, max_new, vocab):
        if sorted(out) != list(range(n_req)):
            fail(f"{name}: missing requests {sorted(out)}")
        for rid, toks in out.items():
            if len(toks) != max_new or min(toks) < 0 or max(toks) >= vocab:
                fail(f"{name}: request {rid} returned {toks}")

    # ---------------------------------------------------------------- encdec
    wcfg = get_config("whisper-large-v3").with_(attn_impl="pallas", remat="none",
                                                param_dtype="bfloat16")
    wmodel = build_model(wcfg, dev)
    t0 = time.time()
    wparams, _ = wmodel.init(torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    w_init = time.time() - t0
    # max_seq: whisper's text context (448 tokens); the pool holds the cross
    # K/V (1500 frames) whole whatever max_seq is
    W_LENS, W_NEW, W_SLOTS, W_MAX_SEQ = [4, 16, 64, 224], 32, 4, 448
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rng = np.random.default_rng(SEED + 5)
    w_prompts = [{
        "frames": (0.02 * torch.randn(1, wcfg.encoder_seq, wcfg.d_model,
                                      generator=g, device=dev)).to(torch.bfloat16),
        "tokens": torch.as_tensor(rng.integers(0, wcfg.vocab_size, size=(1, n)),
                                  device=dev)} for n in W_LENS]

    def w_step(rows, last):
        return {"tokens": last}

    # warm-up: the same prompts, 2 new tokens
    pool_serve(wmodel, wparams, w_prompts, w_step, 2, W_SLOTS, W_MAX_SEQ)
    enc_fn, enc_s = mencdec.encode, []

    def timed_encode(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = enc_fn(*a, **k)
        torch.cuda.synchronize()
        enc_s.append(time.perf_counter() - t)
        return y

    torch.cuda.reset_peak_memory_stats()
    mencdec.encode = timed_encode
    reset_counts()                                   # main path starts here
    try:
        wout, w_pre, w_ticks, w_first, w_wall, w_tick, _ = pool_serve(
            wmodel, wparams, w_prompts, w_step, W_NEW, W_SLOTS, W_MAX_SEQ)
    finally:
        mencdec.encode = enc_fn
    encdec_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    encdec_routes = route_counts()
    w_peak = torch.cuda.max_memory_allocated()
    check_pool_outputs("encdec", wout, len(W_LENS), W_NEW, wcfg.vocab_size)
    # the decoder's causal prefill, once a layer a request; the encoder's
    # and the cross attention (not causal) take the eager flash
    check_launches("encdec", encdec_launches, {
        **{n: 0 for n in kernel_wrappers},
        "flash_attention_fwd": len(W_LENS) * wcfg.num_layers})
    check_launches("encdec routes", encdec_routes["flash_attention_fwd"],
                   {"wgmma": len(W_LENS) * wcfg.num_layers, "fma": 0})
    # full-width logits through the kernel against the eager flash, and each
    # request's first decode step against the full forward of prompt + 1
    wlast = w_prompts[-1]
    w_k, _, _ = wmodel.forward(wparams, wlast)
    w_e, _, _ = build_model(wcfg.with_(attn_impl="xla"), dev).forward(wparams, wlast)
    if tuple(w_k.shape) != (1, W_LENS[-1], wcfg.vocab_size) or not torch.isfinite(
            w_k.float()).all():
        fail(f"whisper logits: shape {tuple(w_k.shape)} or non-finite values")
    w_kernel_vs_eager = rel_err(w_k, w_e)
    w_argmax = float((w_k.argmax(-1) == w_e.argmax(-1)).float().mean())
    del w_k, w_e
    w_dec_vs_fwd = []
    for rid, batch in enumerate(w_prompts):
        longer = {"frames": batch["frames"], "tokens": torch.cat([
            batch["tokens"], torch.tensor([[wout[rid][0]]], device=dev)], dim=1)}
        full, _, _ = wmodel.forward(wparams, longer, last_token_only=True)
        w_dec_vs_fwd.append(rel_err(w_first[rid], full[0, -1]))
    torch.cuda.synchronize()
    if w_kernel_vs_eager >= MODEL_TOL or max(w_dec_vs_fwd) >= MODEL_TOL:
        fail(f"whisper: kernel vs eager {w_kernel_vs_eager:.3e}, decode vs "
             f"forward {w_dec_vs_fwd} (limit {MODEL_TOL})")
    # where the time goes: 4 more ticks, and the longest request's prefill,
    # under the profiler (after the counts were read)
    w_tick_prof = device_profile(w_tick, 4, "tick")
    del w_tick
    w_prefill_prof = device_profile(lambda: wmodel.forward(
        wparams, wlast, return_cache=True, last_token_only=True), 1, "prefill")
    w_tokens = sum(map(len, wout.values()))
    emit("encdec", arch=wcfg.name, encoder_layers=wcfg.encoder_layers,
         decoder_layers=wcfg.num_layers, d_model=wcfg.d_model,
         heads=wcfg.num_heads, head_dim=wcfg.head_dim, vocab=wcfg.vocab_size,
         encoder_seq=wcfg.encoder_seq, params=param_count(wparams),
         param_dtype=wcfg.param_dtype, attn_impl=wcfg.attn_impl,
         init_seconds=w_init, requests=len(W_LENS), prompt_lens=W_LENS,
         max_new=W_NEW, slots=W_SLOTS, max_seq=W_MAX_SEQ, tokens=w_tokens,
         ticks=len(w_ticks), wall_seconds=w_wall, tok_per_s=w_tokens / w_wall,
         encoder_ms=[t * 1e3 for t in enc_s],
         decoder_prefill_ms=[(t - e) * 1e3 for (_, t), e in zip(w_pre, enc_s)],
         prefill_ms={str(n): t * 1e3 for n, t in w_pre},
         tick_ms_median=statistics.median(w_ticks) * 1e3,
         tick_ms_max=max(w_ticks) * 1e3,
         kv_pool_bytes=wmodel.cache_bytes(W_SLOTS, W_MAX_SEQ),
         launches=encdec_launches, launches_by_route=encdec_routes,
         kernel_vs_eager_rel=w_kernel_vs_eager, argmax_agree=w_argmax,
         decode_vs_forward_rel=w_dec_vs_fwd, tol=MODEL_TOL,
         max_memory_allocated=w_peak, tick_profile=w_tick_prof,
         prefill_profile=w_prefill_prof)
    del wmodel, wparams, w_prompts, w_first
    gc.collect()
    torch.cuda.empty_cache()

    # a model alone on the card: its budget is the card's free memory less
    # what a phase holds beside the resident bytes (the KV pool materialised
    # for a tick, and a prefill's working set: its cache, activations, a
    # streamed product's panels, the logit checks' full-length fp32 logits),
    # under 4 GiB; the host's is MemAvailable less room for a second KV pool
    # while the first one's pages return and the process's own growth
    PREFILL_HEADROOM = HOST_MARGIN = 4 << 30

    def plan_alone(model, slots, max_seq, host_leaves, host_bytes):
        """The offload plan of ``model`` served alone on the card at
        ``slots`` x ``max_seq``, cut from ``Model.init(abstract=True)``
        against the card's free memory and the host's settled MemAvailable
        (caches emptied first). Fails before anything is drawn if the plan
        does not fit the card or the host (the depth is never cut at run
        time), or does not spill exactly ``host_leaves`` (``host_bytes``).
        Returns (the abstract parameters, the plan, the row's fields, the
        device's allocated bytes and MemAvailable before)."""
        gc.collect()
        torch.cuda.empty_cache()
        torch._C._host_emptyCache()  # free blocks of the caching host allocator
        dev_before = torch.cuda.memory_allocated()
        host_before = settled_mem_available()
        shapes, _ = model.init(abstract=True)
        inv = model.serving_inventory(shapes, model.cache_shapes(slots, max_seq))
        card_free, _ = torch.cuda.mem_get_info()
        hbm_budget = (card_free - model.cache_bytes(slots, max_seq)
                      - PREFILL_HEADROOM)
        host_budget = host_before - HOST_MARGIN
        plan = plan_offload(inv, hbm_budget, host_budget=host_budget)
        plan_row = {"offloaded": list(plan.offloaded),
                    "partial": list(plan.partial),
                    "resident_bytes": plan.resident_bytes,
                    "host_bytes": plan.host_bytes}
        name = f"{model.cfg.name} at {model.cfg.num_layers} layers"
        if not plan.fits or plan.host_bytes > host_budget:
            fail(f"{name} does not fit: {plan.resident_bytes} resident bytes "
                 f"for a card budget of {hbm_budget} (free {card_free}), "
                 f"{plan.host_bytes} host bytes for a host budget of "
                 f"{host_budget} (MemAvailable {host_before})")
        if (sorted(plan.offloaded) != sorted(host_leaves) or plan.partial
                or plan.host_bytes != host_bytes):
            fail(f"{name}'s plan is {plan_row}, not {sorted(host_leaves)} "
                 f"({host_bytes} bytes) on the host")
        fields = dict(card_free_bytes=card_free, hbm_budget=hbm_budget,
                      prefill_headroom_bytes=PREFILL_HEADROOM,
                      host_mem_available_before=host_before,
                      host_budget=host_budget, host_margin_bytes=HOST_MARGIN,
                      plan=plan_row)
        return shapes, plan, fields, dev_before, host_before

    # ------------------------------------------------------------------ vlm
    # qwen2-vl-72b at full width and all 80 layers: 145.4 GB of bf16 weights
    # on an 80 GB card. The reference's planner (plan_offload) puts the
    # token table, the KV pool and the gate and input MLP stacks, 82.7 GB,
    # in pinned host memory; each parameter is drawn straight into its tier
    # (Model.init with the plan's placement), and the two stacks stream
    # through stream_matmul on every prefill and tick. Nothing else is
    # resident while it runs.
    qcfg = get_config("qwen2-vl-72b").with_(attn_impl="pallas", remat="none",
                                            param_dtype="bfloat16")
    GRIDS, PREFIX, SUFFIX = [(16, 16), (24, 32), (32, 32), (8, 8)], 8, 16
    Q_NEW, Q_SLOTS, Q_MAX_SEQ = 8, 4, 2048
    Q_HOST = ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate",
              "params/layers/w_in")
    Q_HOST_BYTES = 82_686_509_056
    Q_STREAMED = ("w_gate", "w_in")
    qmodel = build_model(qcfg, dev)
    q_shapes, q_plan, q_fields, q_dev_before, q_host_before = plan_alone(
        qmodel, Q_SLOTS, Q_MAX_SEQ, Q_HOST, Q_HOST_BYTES)
    q_placement = param_placement(q_shapes, q_plan, dev)
    q_sizes = {p: t.numel() * t.element_size()
               for p, t in _flatten_with_paths(q_shapes)}
    q_resident = sum(b for p, b in q_sizes.items()
                     if q_placement[p] == "device")
    q_largest_host = max(b for p, b in q_sizes.items()
                         if q_placement[p] == "pinned_host")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    qparams, _ = qmodel.init(torch.Generator(device=dev).manual_seed(SEED),
                             placement=q_placement)
    torch.cuda.synchronize()
    q_init = time.time() - t0
    q_init_peak = torch.cuda.max_memory_allocated() - q_dev_before
    # the pool's host leaves are the rest of the plan's host bytes
    q_pool = KVPool(qmodel, Q_SLOTS, Q_MAX_SEQ, plan=q_plan)
    q_pool_kinds = q_pool.memory_kinds()
    q_host_taken = q_host_before - mem_available_bytes()
    del q_pool
    q_kinds = {p: memory_kind_of(t) for p, t in _flatten_with_paths(qparams)}
    if q_kinds != q_placement:
        fail(f"qwen2-vl-72b leaves outside their planned tiers: "
             f"{ {p: k for p, k in q_kinds.items() if k != q_placement[p]} }")
    for name in Q_STREAMED:
        if not (qparams["layers"][name].is_pinned()
                and qparams["layers"][name][0].is_pinned()):
            fail(f"layers/{name} or its layer 0 is not pinned")
    if q_pool_kinds != {"pinned_host"}:
        fail(f"qwen2-vl-72b's KV pool is in {q_pool_kinds}, not pinned host")
    if abs(q_host_taken - Q_HOST_BYTES) > 0.02 * Q_HOST_BYTES:
        fail(f"placement took {q_host_taken} bytes of host memory by "
             f"MemAvailable, not within 2% of the plan's {Q_HOST_BYTES}")
    # the device allocator hands out a cached block unsplit when under 1 MiB
    # would be left over
    rounding = (1 << 20) * len(q_sizes)
    if q_init_peak > q_resident + q_largest_host + rounding:
        fail(f"placed init peaked at {q_init_peak} device bytes, above the "
             f"resident {q_resident} and one host leaf {q_largest_host}")
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rng = np.random.default_rng(SEED + 6)

    def text_embeds(ids):
        return mlayers.embed_tokens(qcfg, qparams, ids)

    def vlm_prompt(gh, gw):
        """PREFIX text tokens, a gh x gw image (the stubbed vision tower's
        embeddings), SUFFIX text tokens, laid out on the three M-RoPE
        streams as Qwen2-VL lays out one image; also the position the next
        token takes on all three streams."""
        ids = torch.as_tensor(rng.integers(0, qcfg.vocab_size,
                                           size=(1, PREFIX + SUFFIX)), device=dev)
        image = (0.02 * torch.randn(1, gh * gw, qcfg.d_model, generator=g,
                                    device=dev)).to(torch.bfloat16)
        embeds = torch.cat([text_embeds(ids[:, :PREFIX]), image,
                            text_embeds(ids[:, PREFIX:])], dim=1)
        a = PREFIX
        idx = torch.arange(gh * gw, device=dev)
        rows, cols = idx // gw, idx % gw
        start = a + max(gh, gw)
        positions = torch.cat([
            torch.arange(a, device=dev).expand(3, a),
            torch.stack([torch.full_like(rows, a), a + rows, a + cols]),
            torch.arange(start, start + SUFFIX, device=dev).expand(3, SUFFIX)],
            dim=1)[:, None, :]
        return {"embeds": embeds, "positions": positions}, start + SUFFIX

    q_prompts, q_next = zip(*(vlm_prompt(gh, gw) for gh, gw in GRIDS))
    q_lens = [p["embeds"].shape[1] for p in q_prompts]
    q_steps = {}

    def q_step(rows, last):
        """Table rows of the last tokens; each request's M-RoPE position
        moves on from its prompt's, one a step, on all three streams (the
        cache index, ``pos``, is another number)."""
        for r in rows:
            q_steps[r] = q_steps.get(r, -1) + 1
        mpos = torch.tensor([q_next[r] + q_steps[r] for r in rows], device=dev)
        return {"embeds": text_embeds(last),
                "positions": mpos.view(1, -1, 1).expand(3, -1, 1)}

    # warm-up: one request in a one-slot pool, one tick (every pass streams
    # 77.5 GB)
    pool_serve(qmodel, qparams, q_prompts[:1], q_step, 2, 1, Q_MAX_SEQ,
               plan=q_plan)
    q_steps.clear()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                   # main path starts here
    qout, q_pre, q_ticks, q_first, q_wall, q_tick, q_pool = pool_serve(
        qmodel, qparams, q_prompts, q_step, Q_NEW, Q_SLOTS, Q_MAX_SEQ,
        plan=q_plan)
    vlm_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    vlm_routes = route_counts()
    vlm_stream_routes = dict(sm.stream_matmul.launches_by_route)
    q_weight_h2d = sm.stream_matmul.h2d_bytes
    q_rows_h2d = mlayers.gather_rows.h2d_bytes
    q_peak = torch.cuda.max_memory_allocated()
    q_passes = len(q_pre) + len(q_ticks)
    q_stream_calls = q_passes * qcfg.num_layers * len(Q_STREAMED)
    q_layer_bytes = sum(qparams["layers"][n][0].numel()
                        * qparams["layers"][n].element_size() for n in Q_STREAMED)
    q_pass_bytes = q_layer_bytes * qcfg.num_layers
    check_pool_outputs("vlm", qout, len(GRIDS), Q_NEW, qcfg.vocab_size)
    check_launches("vlm", vlm_launches, {
        **{n: 0 for n in kernel_wrappers},
        "flash_attention_fwd": len(GRIDS) * qcfg.num_layers,
        "stream_matmul": q_stream_calls})
    check_launches("vlm routes", vlm_routes["flash_attention_fwd"],
                   {"wgmma": len(GRIDS) * qcfg.num_layers, "fma": 0})
    check_launches("vlm stream_matmul routes", vlm_stream_routes,
                   {"ring": q_stream_calls, "resident": 0})
    if q_pass_bytes != 77_510_737_920 or q_weight_h2d != q_passes * q_pass_bytes:
        fail(f"stream_matmul streamed {q_weight_h2d} bytes in {q_passes} "
             f"passes, expected {q_pass_bytes} a pass")
    q_row_bytes = qcfg.d_model * qparams["tok_embed"].element_size()
    if q_rows_h2d != len(q_ticks) * Q_SLOTS * q_row_bytes:
        fail(f"table rows moved {q_rows_h2d} bytes, expected {len(q_ticks)} "
             f"ticks x {Q_SLOTS} rows x {q_row_bytes}")
    q_kv_row = {"host_bytes": q_pool.host_bytes,
                "device_bytes": q_pool.device_bytes,
                "h2d_bytes_per_tick": q_pool.h2d_bytes / len(q_ticks),
                "d2h_bytes_per_tick": q_pool.d2h_bytes / len(q_ticks),
                "paste_host_bytes": q_pool.paste_host_bytes}
    del q_pool
    big = q_prompts[q_lens.index(max(q_lens))]
    q_k, _, _ = qmodel.forward(qparams, big)
    q_e, _, _ = build_model(qcfg.with_(attn_impl="xla"), dev).forward(qparams, big)
    if tuple(q_k.shape) != (1, max(q_lens), qcfg.vocab_size) or not torch.isfinite(
            q_k.float()).all():
        fail(f"qwen2-vl logits: shape {tuple(q_k.shape)} or non-finite values")
    q_kernel_vs_eager = rel_err(q_k, q_e)
    q_argmax = float((q_k.argmax(-1) == q_e.argmax(-1)).float().mean())
    del q_k, q_e
    q_dec_vs_fwd = []
    for rid, batch in enumerate(q_prompts):
        tok = torch.tensor([[qout[rid][0]]], device=dev)
        longer = {"embeds": torch.cat([batch["embeds"], text_embeds(tok)], dim=1),
                  "positions": torch.cat([batch["positions"], torch.full(
                      (3, 1, 1), q_next[rid], device=dev)], dim=2)}
        full, _, _ = qmodel.forward(qparams, longer, last_token_only=True)
        q_dec_vs_fwd.append(rel_err(q_first[rid], full[0, -1]))
    torch.cuda.synchronize()
    if q_kernel_vs_eager >= MODEL_TOL or max(q_dec_vs_fwd) >= MODEL_TOL:
        fail(f"qwen2-vl: kernel vs eager {q_kernel_vs_eager:.3e}, decode vs "
             f"forward {q_dec_vs_fwd} (limit {MODEL_TOL})")
    q_tick_prof = device_profile(q_tick, 2, "tick")
    del q_tick
    q_prefill_prof = device_profile(lambda: qmodel.forward(
        qparams, big, return_cache=True, last_token_only=True), 1, "prefill")
    q_tokens = sum(map(len, qout.values()))
    q_row = dict(
        arch=qcfg.name, card=card_line, layers=qcfg.num_layers,
        d_model=qcfg.d_model, heads=qcfg.num_heads, kv_heads=qcfg.num_kv_heads,
        head_dim=qcfg.head_dim, d_ff=qcfg.d_ff, vocab=qcfg.vocab_size,
        params=param_count(qparams), param_dtype=qcfg.param_dtype,
        attn_impl=qcfg.attn_impl, **q_fields,
        host_bytes_taken={"mem_available": q_host_taken, "plan": Q_HOST_BYTES},
        init_seconds=q_init, init_peak_device_bytes=q_init_peak,
        resident_param_bytes=q_resident, largest_host_leaf_bytes=q_largest_host,
        memory_allocated_before_init=q_dev_before,
        requests=len(GRIDS), image_grids=GRIDS,
        prompt_lens=q_lens, next_mrope_positions=list(q_next), max_new=Q_NEW,
        slots=Q_SLOTS, max_seq=Q_MAX_SEQ, tokens=q_tokens, prefills=len(q_pre),
        ticks=len(q_ticks), wall_seconds=q_wall, tok_per_s=q_tokens / q_wall,
        prefill_ms={str(n): t * 1e3 for n, t in q_pre},
        prefill_ms_median=statistics.median(t for _, t in q_pre) * 1e3,
        tick_ms_median=statistics.median(q_ticks) * 1e3,
        tick_ms_max=max(q_ticks) * 1e3,
        kv_pool_bytes=qmodel.cache_bytes(Q_SLOTS, Q_MAX_SEQ), kv=q_kv_row,
        launches=vlm_launches, launches_by_route=vlm_routes,
        stream_matmul_launches_by_route=vlm_stream_routes,
        stream_matmul_h2d_bytes=q_weight_h2d,
        weight_h2d_bytes_per_pass=q_pass_bytes,
        weight_gb_per_s_over_tick=q_pass_bytes / statistics.median(q_ticks) / 1e9,
        table_rows_h2d_bytes=q_rows_h2d,
        kernel_vs_eager_rel=q_kernel_vs_eager, argmax_agree=q_argmax,
        decode_vs_forward_rel=q_dec_vs_fwd, tol=MODEL_TOL,
        max_memory_allocated=q_peak, tick_profile=q_tick_prof,
        prefill_profile=q_prefill_prof)
    del qmodel, qparams, q_prompts, q_first, big, batch, longer, full
    gc.collect()
    torch.cuda.empty_cache()
    q_dev_after = torch.cuda.memory_allocated()
    q_host_after = settled_mem_available()
    emit("vlm", **q_row, memory_allocated_after=q_dev_after,
         host_mem_available_after=q_host_after)
    if abs(q_dev_after - q_dev_before) > (64 << 20):
        fail(f"vlm: device memory {q_dev_after} after the phase, "
             f"{q_dev_before} before")
    if abs(q_host_after - q_host_before) > (2 << 30):
        fail(f"vlm: MemAvailable {q_host_after} after the phase, "
             f"{q_host_before} before")

    # ------------------------------------------------------------- moe_full
    # phi3.5-moe-42b-a6.6b at full width and all 32 layers: 83.7 GB of bf16
    # weights and a 1.07 GB KV pool on an 80 GB card, served through
    # SliceRuntime.add_tenant. plan_offload puts the token table, the KV pool
    # and the gate expert stack (28,179,955,712 bytes) in pinned host memory,
    # each parameter drawn straight into its tier; every prefill and tick
    # streams the stack's 32 layer slices (838,860,800 bytes each) through
    # grouped_matmul from those pages. Nothing else is resident while it runs.
    P_HOST = ("params/tok_embed", "kv/k", "kv/v", "params/layers/w_gate")
    P_HOST_BYTES = 28_179_955_712
    P_PASS_BYTES = 26_843_545_600          # w_gate's 32 layer slices

    def moe_full():
        """The phase; returns its row, launches, routes and the memory
        readings before it. Its tensors die with its frame."""
        t_phase = time.time()
        pcfg = get_config("phi3.5-moe-42b-a6.6b").with_(
            attn_impl="pallas", remat="none", param_dtype="bfloat16")
        E, TOPK = pcfg.num_experts, pcfg.experts_per_token
        meta = build_model(pcfg, dev)
        shapes, plan, plan_fields, dev_before, host_before = plan_alone(
            meta, SLOTS, MAX_SEQ, P_HOST, P_HOST_BYTES)
        placement = param_placement(shapes, plan, dev)
        resident = sum(t.numel() * t.element_size()
                       for p, t in _flatten_with_paths(shapes)
                       if placement[p] == "device")
        rt = SliceRuntime(device=dev)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        tenant = rt.add_tenant(TenantSpec(
            "phi35", pcfg, profile="1s.16c", slots=SLOTS, max_seq=MAX_SEQ,
            hbm_budget=plan_fields["hbm_budget"], seed=SEED))
        torch.cuda.synchronize()
        init_s = time.time() - t0
        init_peak = torch.cuda.max_memory_allocated() - dev_before
        host_taken = host_before - mem_available_bytes()
        model, params, eng = tenant.model, tenant.params, tenant.engine
        if tenant.plan != plan:
            fail(f"add_tenant planned {tenant.plan}, not {plan_fields['plan']}")
        kinds = {p: memory_kind_of(t) for p, t in _flatten_with_paths(params)}
        if kinds != placement:
            fail(f"phi3.5-moe leaves outside their planned tiers: "
                 f"{ {p: k for p, k in kinds.items() if k != placement[p]} }")
        w_gate = params["layers"]["w_gate"]
        if not (w_gate.is_pinned() and w_gate[0].is_pinned()):
            fail("layers/w_gate or its layer 0 is not pinned")
        if eng.pool.memory_kinds() != {"pinned_host"}:
            fail(f"phi3.5-moe's KV pool is in {eng.pool.memory_kinds()}")
        if abs(host_taken - P_HOST_BYTES) > 0.02 * P_HOST_BYTES:
            fail(f"add_tenant took {host_taken} bytes of host memory by "
                 f"MemAvailable, not within 2% of the plan's {P_HOST_BYTES}")
        # w_gate is drawn after w_in and before w_out, its equal, so the
        # draw holds at most the resident bytes
        if abs(init_peak - resident) > (64 << 20):
            fail(f"placed init peaked at {init_peak} device bytes, not the "
                 f"resident {resident} within 64 MiB")
        if param_count(params) != pcfg.param_count():
            fail(f"phi3.5-moe: parameter count {param_count(params)} != "
                 f"{pcfg.param_count()}")
        # warm-up: one request, 2 new tokens (every pass streams 26.8 GB)
        rt.submit("phi35", make_requests(pcfg, LENS[:1], 2))
        rt.run()
        timed_engine(eng)
        admitted0, ticks0 = eng.stats.admitted, eng.stats.ticks
        reqs = [Request(r.rid + 1, r.prompt, r.max_new_tokens)
                for r in make_requests(pcfg, LENS, MAX_NEW)]
        rt.submit("phi35", reqs)
        torch.cuda.reset_peak_memory_stats()
        h2d0, d2h0 = eng.pool.h2d_bytes, eng.pool.d2h_bytes
        reset_counts()                               # main path starts here
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        report = rt.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: w.launches for n, w in kernel_wrappers.items()}
        routes = route_counts()
        stream_routes = dict(sm.stream_matmul.launches_by_route)
        weight_h2d = gmm.grouped_matmul.h2d_bytes
        rows_h2d = mlayers.gather_rows.h2d_bytes
        peak = torch.cuda.max_memory_allocated()
        out = {rid: toks for rid, toks in eng.outputs.items() if rid}  # 0: warm-up
        check_outputs(out, reqs, pcfg, MAX_NEW)
        prefills = eng.stats.admitted - admitted0
        ticks = eng.stats.ticks - ticks0
        passes = prefills + ticks
        check_launches("moe_full", launches, {
            **{n: 0 for n in kernel_wrappers},
            "flash_attention_fwd": prefills * pcfg.num_layers,
            "grouped_matmul": 3 * passes * pcfg.num_layers})
        check_launches("moe_full routes", routes, {
            "flash_attention_fwd": {"wgmma": prefills * pcfg.num_layers,
                                    "fma": 0},
            "flash_attention_fwd_stats": {"wgmma": 0, "fma": 0},
            "flash_attention_bwd_dkdv": {"wgmma": 0, "fma": 0},
            "flash_attention_bwd_dq": {"wgmma": 0, "fma": 0},
            "grouped_matmul": {"wgmma": 3 * passes * pcfg.num_layers,
                               "mma_sync": 0, "fma": 0}})
        check_launches("moe_full stream_matmul routes", stream_routes,
                       {"ring": 0, "resident": 0})
        pass_bytes = pcfg.num_layers * w_gate[0].numel() * w_gate.element_size()
        if pass_bytes != P_PASS_BYTES or weight_h2d != passes * pass_bytes:
            fail(f"grouped_matmul streamed {weight_h2d} bytes in {passes} "
                 f"passes, expected {P_PASS_BYTES} a pass")
        # the table's rows: every prompt token at its prefill, then one row
        # a slot each tick (an idle slot reads row 0)
        row_bytes = pcfg.d_model * params["tok_embed"].element_size()
        want_rows = (sum(LENS) + ticks * SLOTS) * row_bytes
        if rows_h2d != want_rows:
            fail(f"table rows moved {rows_h2d} bytes, expected (prompt "
                 f"tokens + {ticks} ticks x {SLOTS} slots) x {row_bytes}")
        kv_row = {"host_bytes": eng.pool.host_bytes,
                  "device_bytes": eng.pool.device_bytes,
                  "h2d_bytes_per_tick": (eng.pool.h2d_bytes - h2d0) / ticks,
                  "d2h_bytes_per_tick": (eng.pool.d2h_bytes - d2h0) / ticks}
        tokens = sum(map(len, out.values()))
        tick_med = statistics.median(eng.tick_s)

        # the dropped share of the longest prompt's top-k assignments per
        # layer at the served capacity, and its logits through the kernels
        # against the eager attention on the same parameter tensors. With
        # random weights most tokens crowd a few experts (the share is
        # large), so a bf16 rounding that flips one near-tied routing
        # decision moves which tokens later find their expert full: the
        # bf16 figures are printed, and the checks hold fp32 activations
        # (the same bf16 tensors) under FP32_MODEL_TOL, as the moe phase
        # holds its decode
        t_checks = time.time()
        longest = torch.as_tensor(
            np.asarray(reqs[LENS.index(max(LENS))].prompt, np.int64),
            device=dev)[None]
        dropped, slots_fn = [], mmoe._slots

        def counting_slots(cfg, top_w, top_e, C):
            slot_token, keep_w, slot = slots_fn(cfg, top_w, top_e, C)
            dropped.append(float((slot == cfg.num_experts * C).float().mean()))
            return slot_token, keep_w, slot

        mmoe._slots = counting_slots
        try:
            logits_k, _, _ = model.forward(params, {"tokens": longest})
        finally:
            mmoe._slots = slots_fn
        logits_e, _, _ = build_model(pcfg.with_(attn_impl="xla"), dev).forward(
            params, {"tokens": longest})
        if (tuple(logits_k.shape) != (1, max(LENS), pcfg.vocab_size)
                or not torch.isfinite(logits_k.float()).all()):
            fail(f"phi3.5-moe logits: shape {tuple(logits_k.shape)} or "
                 f"non-finite values")
        bf16_kernel_vs_eager = rel_err(logits_k, logits_e)
        bf16_argmax = float((logits_k.argmax(-1) == logits_e.argmax(-1))
                            .float().mean())
        del logits_k, logits_e
        f32 = pcfg.with_(dtype="float32")
        logits_k, _, _ = build_model(f32, dev).forward(params, {"tokens": longest})
        logits_e, _, _ = build_model(f32.with_(attn_impl="xla"), dev).forward(
            params, {"tokens": longest})
        if not torch.isfinite(logits_k).all():
            fail("phi3.5-moe: non-finite fp32 logits")
        kernel_vs_eager = rel_err(logits_k, logits_e)
        argmax = float((logits_k.argmax(-1) == logits_e.argmax(-1))
                       .float().mean())
        del logits_k, logits_e
        # each request's first decode step against the full forward of its
        # prompt and one token. The decode computes every expert densely and
        # drops nothing, so these run at the least capacity factor that
        # drops nothing (C >= S: experts / top-k), fp32, on the same
        # tensors: the 8 requests prefilled alone into an 8-slot fp32 pool,
        # decoded together with per-row pos
        no_drop = build_model(f32.with_(capacity_factor=E / TOPK), dev)
        prompts = [{"tokens": torch.as_tensor(np.asarray(r.prompt, np.int64),
                                              device=dev)[None]} for r in reqs]
        nd_out, _, _, first, _, _, _ = pool_serve(
            no_drop, params, prompts, lambda rows, last: {"tokens": last}, 2,
            len(prompts), MAX_SEQ, dtype=torch.float32)
        check_pool_outputs("moe_full no-drop", nd_out, len(prompts), 2,
                           pcfg.vocab_size)
        dec_vs_fwd = []
        for rid, batch in enumerate(prompts):
            longer = {"tokens": torch.cat([batch["tokens"], torch.tensor(
                [[nd_out[rid][0]]], device=dev)], dim=1)}
            full, _, _ = no_drop.forward(params, longer, last_token_only=True)
            dec_vs_fwd.append(rel_err(first[rid], full[0, -1]))
        torch.cuda.synchronize()
        row = dict(
            arch=pcfg.name, card=card_line, layers=pcfg.num_layers,
            d_model=pcfg.d_model, heads=pcfg.num_heads,
            kv_heads=pcfg.num_kv_heads, experts=E, top_k=TOPK,
            d_ff=pcfg.d_ff, vocab=pcfg.vocab_size, params=param_count(params),
            param_dtype=pcfg.param_dtype, attn_impl=pcfg.attn_impl,
            profile=report["tenants"]["phi35"]["profile"], **plan_fields,
            host_bytes_taken={"mem_available": host_taken,
                              "plan": P_HOST_BYTES},
            init_seconds=init_s, init_peak_device_bytes=init_peak,
            resident_param_bytes=resident,
            memory_allocated_before_init=dev_before,
            requests=len(reqs), prompt_lens=LENS, slots=SLOTS,
            max_seq=MAX_SEQ, max_new=MAX_NEW, tokens=tokens,
            prefills=prefills, ticks=ticks, wall_seconds=wall,
            tok_per_s=tokens / wall,
            prefill_ms={str(n): t * 1e3 for n, t in eng.prefill_s},
            prefill_ms_median=statistics.median(
                t for _, t in eng.prefill_s) * 1e3,
            prefill_ms_1024=max(t for n, t in eng.prefill_s
                                if n == max(LENS)) * 1e3,
            tick_ms_median=tick_med * 1e3,
            tick_ms_max=max(eng.tick_s) * 1e3,
            kv_pool_bytes=meta.cache_bytes(SLOTS, MAX_SEQ), kv=kv_row,
            launches=launches, launches_by_route=routes,
            stream_matmul_launches_by_route=stream_routes,
            grouped_matmul_h2d_bytes=weight_h2d,
            weight_h2d_bytes_per_pass=pass_bytes,
            weight_gb_per_s_over_tick=pass_bytes / tick_med / 1e9,
            table_rows_h2d_bytes=rows_h2d,
            capacity_factor=pcfg.capacity_factor,
            capacity_1024=mmoe.capacity(pcfg, max(LENS)),
            dropped_share_1024_by_layer=dropped,
            dropped_share_1024_mean=statistics.mean(dropped),
            kernel_vs_eager_fp32_rel=kernel_vs_eager, argmax_agree_fp32=argmax,
            no_drop_capacity_factor=E / TOPK,
            decode_vs_forward_fp32_rel=dec_vs_fwd, tol=FP32_MODEL_TOL,
            kernel_vs_eager_bf16_rel=bf16_kernel_vs_eager,
            argmax_agree_bf16=bf16_argmax, max_memory_allocated=peak,
            checks_seconds=time.time() - t_checks,
            phase_seconds=time.time() - t_phase)
        rt.remove_tenant("phi35")
        return row, launches, routes, dev_before, host_before

    p_row, moe_full_launches, moe_full_routes, p_dev_before, p_host_before = \
        moe_full()
    gc.collect()
    torch.cuda.empty_cache()
    p_dev_after = torch.cuda.memory_allocated()
    p_host_after = settled_mem_available()
    emit("moe_full", **p_row, memory_allocated_after=p_dev_after,
         host_mem_available_after=p_host_after)
    if not (p_row["kernel_vs_eager_fp32_rel"] < FP32_MODEL_TOL
            and max(p_row["decode_vs_forward_fp32_rel"]) < FP32_MODEL_TOL):
        fail(f"phi3.5-moe (fp32): kernel vs eager "
             f"{p_row['kernel_vs_eager_fp32_rel']:.3e}, decode vs forward "
             f"{p_row['decode_vs_forward_fp32_rel']} (limit {FP32_MODEL_TOL})")
    if abs(p_dev_after - p_dev_before) > (64 << 20):
        fail(f"moe_full: device memory {p_dev_after} after the phase, "
             f"{p_dev_before} before")
    if abs(p_host_after - p_host_before) > (2 << 30):
        fail(f"moe_full: MemAvailable {p_host_after} after the phase, "
             f"{p_host_before} before")

    # -------------------------------------------------------------- cluster
    # The port's ClusterScheduler places a crafted trace on one modelled pod
    # and executes its serving jobs as live SliceRuntime tenants on the card
    # at full width, causal prefills through the flash kernel: gpt2-124m,
    # phi3-mini-3.8b (head dim 96) and llama3-8b together (~24 GB of bf16
    # weights) beside a modelled batch job, then qwen3-32b (65.5 GB) alone
    # once they are gone. The timeline must be the one the same script gets
    # from the port on the CPU with the default (reduced) tenants.
    from repro_torch.cluster import ClusterScheduler, Job
    from repro_torch.configs import tenant_config

    def cluster_trace():
        return [Job(0, "serving", "gpt2-124m", "decode_32k", 0.0, 50,
                    requests=2, duration_s=100.0),
                Job(1, "serving", "phi3-mini-3.8b", "decode_32k", 5.0, 50,
                    requests=2, duration_s=100.0),
                Job(2, "batch", "mamba2-130m", "decode_32k", 5.0, 50,
                    u_compute=0.1),
                Job(3, "serving", "llama3-8b", "decode_32k", 10.0, 50,
                    requests=2, duration_s=100.0),
                Job(4, "serving", "qwen3-32b", "decode_32k", 500.0, 50,
                    requests=2, duration_s=100.0)]

    def timeline_sha(records):
        return hashlib.sha256(repr([(r.job.job_id, r.place_s, r.finish_s)
                                    for r in records]).encode()).hexdigest()

    def full_width(arch):
        return tenant_config(arch, full_size=True, attn_impl="pallas")

    t0 = time.perf_counter()
    cpu_sched = ClusterScheduler(n_pods=1, policy="frag_repack",
                                 execute_serving=True, device="cpu")
    cpu_records, _ = cpu_sched.run(cluster_trace())
    cpu_seconds = time.perf_counter() - t0
    cpu_sha = timeline_sha(cpu_records)

    # per tenant: add_tenant and drain seconds, whether the first decode's
    # logits are finite, who else was on the card, memory after the add
    from repro_torch.models.model_zoo import Model
    tenant_log, current = {}, {}
    real_add, real_start = SliceRuntime.add_tenant, ClusterScheduler._start_tenant
    real_decode = Model.decode

    def logged_decode(model, params, cache, batch):
        logits, cache = real_decode(model, params, cache, batch)
        entry = current.get("entry")
        if entry is not None and "first_logits_finite" not in entry:
            entry["first_logits_finite"] = bool(torch.isfinite(logits.float()).all())
        return logits, cache

    def logged_add(runtime, spec):
        entry = {"co_tenants": sorted(runtime.tenants),
                 "memory_allocated_before_add": torch.cuda.memory_allocated()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        tenant = real_add(runtime, spec)
        torch.cuda.synchronize()
        entry["add_tenant_s"] = time.perf_counter() - t
        entry["memory_allocated_after_add"] = torch.cuda.memory_allocated()
        tenant_log[spec.name] = current["entry"] = entry
        return tenant

    def logged_start(sched, rec, pod, cand):
        before = (fa.flash_attention_fwd.launches,
                  dict(fa.flash_attention_fwd.launches_by_route))
        torch.cuda.synchronize()
        t = time.perf_counter()
        slice_id = real_start(sched, rec, pod, cand)
        torch.cuda.synchronize()
        entry = tenant_log[rec.job.tag]
        entry["drain_s"] = time.perf_counter() - t - entry["add_tenant_s"]
        current.clear()
        cfg = pod.runtime.tenants[rec.job.tag].spec.cfg
        entry.update(
            arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
            head_dim=cfg.head_dim, params=cfg.param_count(),
            param_dtype=cfg.param_dtype, profile=cand.profile.name,
            tokens_out=rec.tokens_out,
            smoke_tok_per_s=rec.tokens_out / entry["drain_s"],
            flash_launches=fa.flash_attention_fwd.launches - before[0],
            flash_launches_by_route={
                r: n - before[1][r]
                for r, n in fa.flash_attention_fwd.launches_by_route.items()})
        # the first request's prompt, drawn as _start_tenant draws it, through
        # the tenant's own model (prefill through the flash kernel) and an
        # eager one on the same weights; these launches are a comparison and
        # are taken back out of the path's counts
        saved = ({n: w.launches for n, w in kernel_wrappers.items()},
                 route_counts())
        rng = np.random.default_rng(1000 + rec.job.job_id)
        prompt = rng.integers(0, cfg.vocab_size, size=int(rng.integers(4, 9)))
        toks = torch.as_tensor(prompt[None], device=dev)
        tenant = pod.runtime.tenants[rec.job.tag]
        logits_k, _, _ = tenant.model.forward(tenant.params, {"tokens": toks})
        check_routes = {r: n - saved[1]["flash_attention_fwd"][r]
                        for r, n in fa.flash_attention_fwd.launches_by_route.items()}
        logits_e, _, _ = build_model(cfg.with_(attn_impl="xla"), dev).forward(
            tenant.params, {"tokens": toks})
        torch.cuda.synchronize()
        for n, w in kernel_wrappers.items():
            w.launches = saved[0][n]
        for n, w in routed.items():
            w.launches_by_route = dict(saved[1][n])
        if (tuple(logits_k.shape) != (1, len(prompt), cfg.vocab_size)
                or not torch.isfinite(logits_k.float()).all()):
            fail(f"cluster: {rec.job.tag}'s logits: shape "
                 f"{tuple(logits_k.shape)} or non-finite values")
        if check_routes != {"wgmma": cfg.num_layers, "fma": 0}:
            fail(f"cluster: {rec.job.tag}'s checked forward launched the flash "
                 f"kernel {check_routes}, not {cfg.num_layers} x wgmma")
        entry.update(
            check_prompt_tokens=len(prompt),
            kernel_vs_eager_rel=rel_err(logits_k, logits_e),
            argmax_agree=float((logits_k.argmax(-1) == logits_e.argmax(-1))
                               .float().mean()))
        del tenant, logits_k, logits_e
        if entry["kernel_vs_eager_rel"] >= MODEL_TOL:
            fail(f"cluster: {rec.job.tag}'s logits, kernel vs eager "
                 f"{entry['kernel_vs_eager_rel']:.3e} >= {MODEL_TOL}")
        return slice_id

    gc.collect()
    torch.cuda.empty_cache()
    c_before = torch.cuda.memory_allocated()
    SliceRuntime.add_tenant = logged_add
    ClusterScheduler._start_tenant = logged_start
    Model.decode = logged_decode
    sched = ClusterScheduler(n_pods=1, policy="frag_repack",
                             execute_serving=True, device="cuda",
                             serving_config=full_width)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()                                   # main path starts here
    t0 = time.perf_counter()
    c_records, c_metrics = sched.run(cluster_trace())
    torch.cuda.synchronize()
    c_wall = time.perf_counter() - t0
    cluster_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    cluster_routes = route_counts()
    SliceRuntime.add_tenant, ClusterScheduler._start_tenant = real_add, real_start
    Model.decode = real_decode
    c_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    c_after = torch.cuda.memory_allocated()
    c_sha = timeline_sha(c_records)
    if c_sha != cpu_sha:
        fail(f"cluster: the card's timeline {c_sha} != the CPU run's {cpu_sha}")
    serving = [r for r in c_records if r.job.kind == "serving"]
    by_id = {r.job.job_id: r for r in c_records}
    for r in serving:
        entry = tenant_log.get(r.job.tag)
        if not r.executed or entry is None:
            fail(f"cluster: serving job {r.job.tag} was not executed")
        if r.tokens_out != r.job.requests * sched.serving_max_new:
            fail(f"cluster: {r.job.tag} decoded {r.tokens_out} tokens, not "
                 f"requests x max_new = {r.job.requests * sched.serving_max_new}")
        if not entry.get("first_logits_finite"):
            fail(f"cluster: {r.job.tag}'s first decode gave non-finite logits")
        cfg = full_width(r.job.arch)
        if (entry["layers"], entry["d_model"]) != (cfg.num_layers, cfg.d_model):
            fail(f"cluster: {r.job.tag} did not run at full width and depth")
        want = r.job.requests * cfg.num_layers
        if entry["flash_launches_by_route"] != {"wgmma": want, "fma": 0}:
            fail(f"cluster: {r.job.tag} flash launches "
                 f"{entry['flash_launches_by_route']} != requests x layers = "
                 f"{want}, all wgmma")
    if any(r.executed for r in c_records if r.job.kind != "serving"):
        fail("cluster: a modelled (non-serving) job was executed")
    qwen = by_id[4]
    if max(by_id[i].finish_s for i in (0, 1, 3)) > qwen.place_s:
        fail("cluster: qwen3-32b was placed before the first three finished")
    if tenant_log[qwen.job.tag]["co_tenants"]:
        fail(f"cluster: qwen3-32b shared the card with "
             f"{tenant_log[qwen.job.tag]['co_tenants']}")
    want_flash = sum(r.job.requests * full_width(r.job.arch).num_layers
                     for r in serving)
    check_launches("cluster", cluster_launches, {
        **{n: 0 for n in kernel_wrappers}, "flash_attention_fwd": want_flash})
    check_launches("cluster routes", cluster_routes["flash_attention_fwd"],
                   {"wgmma": want_flash, "fma": 0})
    pod = sched.pods[0]
    if pod.runtime.tenants or pod.partitioner.free_chips() != sched.pod_spec.n_chips:
        fail(f"cluster: tenants left {sorted(pod.runtime.tenants)}, free chips "
             f"{pod.partitioner.free_chips()} of {sched.pod_spec.n_chips}")
    if abs(c_after - c_before) > 64 << 20:
        fail(f"cluster: device memory {c_after} bytes after the run, "
             f"{c_before} before (more than 64 MiB apart)")
    emit("cluster", card=card_line, policy="frag_repack", pods=1,
         pod_chips=sched.pod_spec.n_chips, serving_slots=sched.serving_slots,
         serving_max_seq=sched.serving_max_seq,
         serving_max_new=sched.serving_max_new, timeline_sha=c_sha,
         cpu_timeline_sha=cpu_sha, cpu_seconds=cpu_seconds,
         jobs=[{"job": r.job.job_id, "kind": r.job.kind, "arch": r.job.arch,
                "profile": r.profile_name, "place_s": r.place_s,
                "finish_s": r.finish_s, "executed": r.executed,
                "tokens_out": r.tokens_out} for r in c_records],
         tenants=tenant_log, completed=c_metrics.completed,
         makespan_s=c_metrics.makespan_s, wall_seconds=c_wall,
         launches=cluster_launches, launches_by_route=cluster_routes,
         launches_formula="sum over serving jobs of requests x layers",
         tol=MODEL_TOL,
         hd96_launches=tenant_log[by_id[1].job.tag]["flash_launches"],
         max_memory_allocated=c_peak, memory_allocated_before=c_before,
         memory_allocated_after=c_after)
    del sched, c_records, cpu_sched, cpu_records, tenant_log
    gc.collect()
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- dryrun
    # launch/dryrun.py's cells at full size, run, counted and timed on the
    # card into a temporary directory: B3/B4 (gpt2 training), B6 forward and
    # backward with B3/B4 (granite-moe training), B1 at 32,768 tokens (llama3
    # prefill), the plain decode over a 32k cache, B5 at 32,768 tokens
    # (mamba2 prefill), the state decode (mamba2 long_500k)
    from repro_torch.core.perfmodel import PerfModel
    from repro_torch.core.slices import PROFILES
    dry_cells = {("gpt2-124m", "train_4k"): {
                     "flash_attention_fwd_stats", "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dq"},
                 ("granite-moe-1b-a400m", "train_4k"): {
                     "flash_attention_fwd_stats", "flash_attention_bwd_dkdv",
                     "flash_attention_bwd_dq", "grouped_matmul"},
                 ("llama3-8b", "prefill_32k"): {"flash_attention_fwd"},
                 ("llama3-8b", "decode_32k"): set(),
                 ("mamba2-130m", "prefill_32k"): {"ssd_scan"},
                 ("mamba2-130m", "long_500k"): set()}
    gc.collect()
    torch.cuda.empty_cache()
    dry_dir = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry_recs, dry_seconds = {}, {}
    reset_counts()
    for (arch, shape_name), want_kernels in dry_cells.items():
        before = {n: w.launches for n, w in kernel_wrappers.items()}
        t0 = time.time()
        rec = dryrun.run_cell(arch, shape_name, os.path.join(dry_dir, "single"),
                              device="cuda")
        dry_seconds[(arch, shape_name)] = time.time() - t0
        if rec.get("error") or rec.get("skipped"):
            fail(f"dryrun {arch} {shape_name}: "
                 f"{rec.get('error') or rec.get('skipped')}\n{rec.get('trace', '')}")
        delta = {n: w.launches - before[n] for n, w in kernel_wrappers.items()
                 if w.launches != before[n]}
        counted = rec["kernels"]["counted_pass"]
        if counted["count"] != counted["wrappers"]:
            fail(f"dryrun {arch} {shape_name}: counted launches "
                 f"{counted['count']} != the wrappers' {counted['wrappers']}")
        if set(counted["count"]) != want_kernels:
            fail(f"dryrun {arch} {shape_name}: kernels {sorted(counted['count'])}"
                 f", expected {sorted(want_kernels)}")
        passes = 1 + rec["measured"]["warmup"] + rec["measured"]["calls"]
        if delta != {n: c * passes for n, c in counted["count"].items()}:
            fail(f"dryrun {arch} {shape_name}: the cell launched {delta}, not "
                 f"{passes} x the counted pass {counted['count']}")
        for name, routes in counted["routes"].items():
            if name in routed and set(routes) != {"wgmma"}:
                fail(f"dryrun {arch} {shape_name}: {name} routes {routes}, "
                     f"not all wgmma (bf16)")
        if get_shape(shape_name).kind == "train":
            # gpt2-124m's 4,096 positions run past its 1,024 learned ones,
            # whose rows read NaN as the reference's jnp.take reads them
            by_design = "loss_note" in rec
            if bool(np.isfinite(rec["loss"])) == by_design:
                fail(f"dryrun {arch} {shape_name}: loss {rec['loss']}, "
                     f"{rec.get('loss_note', 'expected finite')}")
        numbers = [v for v in rec["roofline"].values()
                   if isinstance(v, (int, float))]
        numbers += [v for v in rec["measured"].values()
                    if isinstance(v, (int, float))]
        if not all(np.isfinite(numbers)):
            fail(f"dryrun {arch} {shape_name}: non-finite figures in the record")
        dry_recs[(arch, shape_name)] = rec
    dry_launches = {n: w.launches for n, w in kernel_wrappers.items()}
    dry_routes = route_counts()

    # the kernels at the shapes the cells' parts gave them, each held to its
    # plain version on finite inputs (gpt2's own step carries NaN rows):
    # the flash training kernels at each train_4k part's heads x 4,096
    # tokens, grouped_matmul forward and backward at granite-moe's capacity
    # rows, the SSD scan at mamba2-130m's prefill_32k part
    def part_sequences(arch, shape_name):
        return dry_recs[(arch, shape_name)]["measured"]["part_sequences"]

    train_s = get_shape("train_4k").seq_len
    path_flash = []
    for arch in ("gpt2-124m", "granite-moe-1b-a400m"):
        cfg = get_config(arch)
        path_flash.append(dict(flash_train_case(
            part_sequences(arch, "train_4k") * cfg.num_heads, train_s,
            cfg.head_dim, "bfloat16", True), arch=arch))
    gcfg = get_config("granite-moe-1b-a400m")
    # moe.apply_moe's groups: one a sequence, split past moe_group_size
    gs = gcfg.moe_group_size
    groups, group_tokens = part_sequences("granite-moe-1b-a400m", "train_4k"), train_s
    if train_s > gs and train_s % gs == 0:
        groups, group_tokens = groups * (train_s // gs), gs
    g_rows = groups * mmoe.capacity(gcfg, group_tokens)
    g_dims = ((gcfg.d_model, gcfg.d_ff), (gcfg.d_ff, gcfg.d_model))
    path_gmm = [gmm_case(gcfg.num_experts, g_rows, K, N, "bfloat16", "device")
                for K, N in g_dims]
    if [c["route"] for c in path_gmm] != ["wgmma"] * len(path_gmm):
        fail(f"grouped_matmul at granite-moe's train_4k rows took "
             f"{[c['route'] for c in path_gmm]}, not wgmma")
    path_gmm_bwd = [gmm_bwd_case(which, gcfg.num_experts, g_rows, K, N)
                    for K, N in g_dims for which in ("dx", "dw")]
    scfg = get_config("mamba2-130m")
    s_rows = part_sequences("mamba2-130m", "prefill_32k")
    path_ssd = (ssd_long_case if s_rows == ssd_long_rows else ssd_case(
        s_rows, get_shape("prefill_32k").seq_len, scfg.ssm_heads,
        scfg.ssm_head_dim, scfg.ssm_state, "bfloat16"))
    perf = PerfModel.from_artifacts(dry_dir)
    dry_rows = []
    for (arch, shape_name), rec in dry_recs.items():
        a = perf.anchors.get((arch, shape_name))
        if a is None:
            fail(f"dryrun: PerfModel.from_artifacts did not load {arch} {shape_name}")
        cfg, shp = get_config(arch), get_shape(shape_name)
        score = next((sc for sc in (perf.score(cfg, shp, p) for p in PROFILES)
                      if sc is not None), None)
        if score is None or not score.calibrated:
            fail(f"dryrun: {arch} {shape_name} scored "
                 f"{'on no profile' if score is None else 'uncalibrated'}")
        wl = perf.workload(cfg, shp)
        r, m = rec["roofline"], rec["measured"]
        dry_rows.append({
            "arch": arch, "shape": shape_name, "k": m["k"],
            "part_sequences": m["part_sequences"],
            "counted_tflop": r["hlo_flops_per_chip"] / 1e12,
            "hbm_gb": r["hlo_bytes_per_chip"] / 1e9,
            "host_gb": rec["host_bytes"] / 1e9,
            "kernel_tflop": rec["kernels"]["flops"] / 1e12,
            "useful_flops_ratio": r["useful_flops_ratio"],
            "calibration_flops": a.flops_global / wl.flops(),
            "calibration_bytes": a.bytes_global / wl.hbm_bytes(),
            "calibrated_on": score.profile.name,
            "part_ms": [m["part_ms_median"], m["part_ms_min"], m["part_ms_max"]],
            "update_ms": m["update_ms"], "step_ms": m["step_ms"],
            "tokens_per_s": m["tokens_per_s"], "mfu": m["mfu"],
            "peak_device_bytes": m["peak_device_bytes"],
            "part_estimate_gib": rec["memory"]["part_estimate_gib"],
            "loss": rec.get("loss"), "loss_note": rec.get("loss_note"),
            "launches_counted_pass": rec["kernels"]["counted_pass"]["count"],
            "launches_step": rec["kernels"]["launches"],
            "roofline_model_dominant": r["dominant"],
            "setup_s": rec["setup_s"], "count_s": rec["count_s"],
            "seconds": dry_seconds[(arch, shape_name)]})
    emit("dryrun", card=card_line, cells=dry_rows, launches=dry_launches,
         launches_by_route=dry_routes,
         path_kernels={"flash_attention_train": path_flash,
                       "grouped_matmul": path_gmm,
                       "grouped_matmul_backward": path_gmm_bwd,
                       "ssd_scan": path_ssd},
         mfu_peak=f"{dryrun.H100_BF16_PEAK_FLOPS:.4g} FLOP/s, "
                  "NVIDIA H100 SXM datasheet, dense BF16",
         roofline_model="the reference's modelled chip (core.hw.V5E): a "
                        "model, not the card's figures")
    shutil.rmtree(dry_dir, ignore_errors=True)
    del dry_recs, perf
    gc.collect()
    torch.cuda.empty_cache()

    # ----------------------------------------------------------------- mesh
    # the reference's sharded step on its production meshes: each cell one
    # device's shard (rank 0 of a fake world of 256 / 512 ranks) run on the
    # card in a child process at full width and depth; the counts set to 0
    # just before each cell and read just after, in the child
    t_mesh = time.time()
    mesh_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    child = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--mesh-child", mesh_dir], capture_output=True,
                           text=True, timeout=900)
    if child.returncode != 0:
        fail(f"mesh: the child process failed ({child.returncode}):\n"
             f"{child.stderr[-3000:]}")
    with open(os.path.join(mesh_dir, "mesh.json")) as f:
        mesh_json = json.load(f)
    mesh_cells, mesh_serve = mesh_json["cells"], mesh_json["serve"]
    mesh_launches = dict.fromkeys(list(routed) + ["ssd_scan"], 0)
    mesh_routes = {n: {} for n in routed}
    mesh_rows = []
    # grouped_matmul's forwards in the MoE cells: (E_local, M, K, N, x
    # shared) -> the cells that launched it there; those of training cells
    mesh_gmm_shapes, mesh_gmm_train = {}, set()
    # ssd_scan's calls in the SSM cells: (B, S, nh_local, hp, N, initial
    # state) -> the cells that launched it there
    mesh_ssd_shapes = {}

    def moe_forwards(cfg, kind, rows, S, e_local):
        """The expert products of one MoE layer as moe.apply_moe runs them
        on ``rows`` local sequences: (E_local, M, K, N, x shared). Routed:
        M = groups x capacity (a group a sequence, or each moe_group_size
        slice of a longer one); the decode: every local row, x shared by
        the experts in w_in / w_gate (expert stride 0; one expert has no
        stride to share)."""
        d, f = cfg.d_model, cfg.d_ff
        if kind == "decode":
            return {(e_local, rows, d, f, e_local > 1),
                    (e_local, rows, f, d, False)}
        gs = cfg.moe_group_size
        groups, tokens = ((rows * (S // gs), gs) if S > gs and S % gs == 0
                          else (rows, S))
        M = groups * mmoe.capacity(cfg, tokens)
        return {(e_local, M, d, f, False), (e_local, M, f, d, False)}

    for cell in mesh_cells:
        rec, arch, shape_name = cell["record"], cell["arch"], cell["shape"]
        tag = (f"mesh {arch} {shape_name} on {cell['mesh_kind']} rank "
               f"{rec.get('rank')}")
        if rec.get("error") or rec.get("skipped"):
            fail(f"{tag}: {rec.get('error') or rec.get('skipped')}\n"
                 f"{rec.get('trace', '')}")
        kind = get_shape(shape_name).kind
        cfg = get_config(arch)
        moe = cfg.family == "moe"
        ssm = cfg.family in ("ssm", "hybrid")
        attn = {"train": MESH_TRAIN_KERNELS, "prefill": {"flash_attention_fwd"},
                "decode": set()}[kind]
        want = ((set() if cfg.family == "ssm" else attn)
                | ({"grouped_matmul"} if moe else set())
                | ({"ssd_scan"} if ssm else set()))
        counted = rec["kernels"]["counted_pass"]
        if set(counted["count"]) != want or counted["count"] != counted["wrappers"]:
            fail(f"{tag}: counted launches {counted['count']} (the wrappers' "
                 f"{counted['wrappers']}), expected kernels {sorted(want)}")
        launched = {n: c for n, c in cell["launches"].items() if c}
        passes = 1 + rec["measured"]["warmup"] + rec["measured"]["calls"]
        if launched != {n: c * passes for n, c in counted["count"].items()}:
            fail(f"{tag}: launched {launched}, not {passes} x the counted "
                 f"pass {counted['count']}")
        # a pass launches each flash kernel once a (decoder) layer, and
        # grouped_matmul once an expert product a layer, dx and dw of each
        # in a training pass; a training pass runs each layer's forward
        # twice under remat (the backward's recompute)
        fwd_per_layer = 2 if kind == "train" and rec["remat"] != "none" else 1
        per_layer = {n: fwd_per_layer if n.startswith("flash_attention_fwd")
                     else 1 for n in want}
        if moe:
            per_layer["grouped_matmul"] = (3 if cfg.glu else 2) * (
                fwd_per_layer + (2 if kind == "train" else 0))
        per_pass = {n: cfg.num_layers * c for n, c in per_layer.items()}
        if ssm:
            # the SSD once a layer's forward: a training pass runs a tail
            # layer's twice and a hybrid group's layers three times (the
            # group's recompute as well); the flash kernels once a shared
            # block's application (n_groups of them), its forward twice
            g = cfg.attn_every if cfg.family == "hybrid" else cfg.num_layers
            groups = cfg.num_layers // g if cfg.family == "hybrid" else 0
            tail = cfg.num_layers - groups * g
            per_pass = {n: groups * c for n, c in per_layer.items()}
            per_pass["ssd_scan"] = (groups * g * (fwd_per_layer + 1)
                                    + tail * fwd_per_layer
                                    if fwd_per_layer == 2 else cfg.num_layers)
        if counted["count"] != per_pass:
            fail(f"{tag}: counted launches {counted['count']}, not the "
                 f"{per_pass} that {cfg.num_layers} layers give")
        for n, routes in cell["launches_by_route"].items():
            if any(c for r, c in routes.items() if r != "wgmma"):
                fail(f"{tag}: {n} routes {routes}, not all wgmma (bf16)")
            for r, c in routes.items():
                mesh_routes[n][r] = mesh_routes[n].get(r, 0) + c
        for n in mesh_launches:
            mesh_launches[n] += cell["launches"][n]
        # local heads: B_part x num_heads / the model axis' size (tp), or
        # the whole heads (fsdp_only, sequence-parallel); a
        # sequence-parallel rank's queries are its 1/16 of the sequence at
        # its offset, over the whole sequence's keys
        pol = rec["policy"]
        heads = cfg.num_heads // (16 if pol["head_sharded"] else 1)
        bh = rec["measured"]["part_sequences"] * heads
        S = get_shape(shape_name).seq_len
        Sq = S // 16 if pol["seq_parallel_attn"] else S
        q_off = rec["coords"]["model"] * Sq if pol["seq_parallel_attn"] else 0
        at = [[bh, Sq, cfg.head_dim], [bh, S, cfg.head_dim], q_off]
        for n, shapes_seen in cell["kernel_shapes"].items():
            if n.startswith("flash") and shapes_seen != [at]:
                fail(f"{tag}: {n} launched at {shapes_seen}, not the local "
                     f"q, k and offset {at}")
        if ssm:
            # every scan on the rank's rows and its nh / 16 SSM heads (all
            # of them fsdp_only), B and C whole
            nh_l = cfg.ssm_heads // (16 if pol["ssm_sharded"] else 1)
            rows = rec["measured"]["part_sequences"]
            at_ssd = [[rows, S, nh_l, cfg.ssm_head_dim],
                      [rows, S, cfg.ssm_state]]
            if (rec.get("ssm_heads_local") != nh_l
                    or cell["kernel_shapes"].get("ssd_scan") != [at_ssd]):
                fail(f"{tag}: ssd_scan launched at "
                     f"{cell['kernel_shapes'].get('ssd_scan')} (record: "
                     f"{rec.get('ssm_heads_local')} heads), not {at_ssd}")
            mesh_ssd_shapes.setdefault(
                (rows, S, nh_l, cfg.ssm_head_dim, cfg.ssm_state,
                 kind == "prefill"), []).append(f"{arch} {shape_name}")
        if moe:
            # every launch on a stack of the rank's E / 16 experts, the
            # forwards at the local capacity rows the routing gives
            e_local = cfg.num_experts // (16 if pol["experts_sharded"] else 1)
            seen = cell["kernel_shapes"]["grouped_matmul"]
            if rec.get("experts_local") != e_local or any(
                    w[0] != e_local for _, w, _ in seen):
                fail(f"{tag}: grouped_matmul launched on stacks of "
                     f"{sorted({w[0] for _, w, _ in seen})} experts (record: "
                     f"{rec.get('experts_local')}), not {e_local}")
            fwds = moe_forwards(cfg, kind, rec["measured"]["part_sequences"],
                                S, e_local)
            launched_at = {(w[0], x[1], w[1], w[2], shared)
                           for x, w, shared in seen}
            if not fwds <= launched_at:
                fail(f"{tag}: grouped_matmul's forwards {sorted(fwds)} not "
                     f"among its launches {sorted(launched_at)}")
            for c in fwds:
                mesh_gmm_shapes.setdefault(c, []).append(f"{arch} {shape_name}")
            if kind == "train":
                mesh_gmm_train |= fwds
        anchors = PerfModel.from_artifacts(mesh_dir, cell["mesh_kind"]).anchors
        if (arch, shape_name) not in anchors:
            fail(f"{tag}: PerfModel.from_artifacts did not load the record")
        r, m = rec["roofline"], rec["measured"]
        numbers = [v for v in r.values() if isinstance(v, (int, float))]
        numbers += [v for v in m.values() if isinstance(v, (int, float))]
        if not all(np.isfinite(numbers)) or r["collective_bytes_per_chip"] <= 0:
            fail(f"{tag}: non-finite figures or no collectives in the record")
        anchor_path = os.path.join(root, "benchmarks", "artifacts", "dryrun",
                                   ANCHOR_DIRS[cell["mesh_kind"]],
                                   f"{arch}__{shape_name}.json")
        anchor = None
        if os.path.exists(anchor_path):
            with open(anchor_path) as f:
                anchor = json.load(f)["roofline"]
        row = {
            "arch": arch, "shape": shape_name, "mesh": rec["mesh"],
            "n_devices": rec["n_devices"], "rank": rec["rank"],
            "coords": rec["coords"], "profile": pol["profile"],
            "seq_parallel_attn": pol["seq_parallel_attn"],
            "seq_residuals": pol["seq_residuals"],
            "k": m["k"], "part_sequences": m["part_sequences"],
            "part_ms": [m["part_ms_median"], m["part_ms_min"], m["part_ms_max"]],
            "update_ms": m["update_ms"], "step_ms": m["step_ms"],
            "counted_tflop_per_device": r["hlo_flops_per_chip"] / 1e12,
            "hbm_gb_per_device": r["hlo_bytes_per_chip"] / 1e9,
            "collective_gb_per_device": r["collective_bytes_per_chip"] / 1e9,
            "collective_gb_by_op": {k: v / 1e9 for k, v in
                                    rec["collectives"]["bytes_by_op"].items()},
            "collective_count_by_op": rec["collectives"]["count_by_op"],
            "kernel_launches_by_route": {n: rs for n, rs in
                                         cell["launches_by_route"].items()
                                         if any(rs.values())},
            "kernel_local_shapes": cell["kernel_shapes"],
            **({"experts_local": rec["experts_local"]} if moe else {}),
            **({"ssm_heads_local": rec["ssm_heads_local"]} if ssm else {}),
            "peak_device_bytes": m["peak_device_bytes"],
            "grad_compression": rec.get("grad_compression"),
            "reference_flops_per_chip": anchor and anchor["hlo_flops_per_chip"],
            "flops_ratio_to_reference": anchor and (
                r["hlo_flops_per_chip"] / anchor["hlo_flops_per_chip"]),
            "reference_collective_gb_per_chip": (
                anchor.get("collective_bytes_per_chip", 0) / 1e9
                if anchor and "collective_bytes_per_chip" in anchor else None),
            "count_s": rec["count_s"], "seconds": cell["seconds"]}
        emit("mesh_cell", **row)
        mesh_rows.append(row)
    for n in mesh_launches:
        if not mesh_launches[n]:
            fail(f"mesh: {n} was launched no time on the mesh path")
    shutil.rmtree(mesh_dir, ignore_errors=True)
    # the serving cells: llama3-8b through SliceRuntime(mesh=...) as rank 0
    # of a fake world; the launches of each kernel held to their formulas
    # (the flash forward once a layer of every prefill, stream_matmul once a
    # layer of every pass where w_gate is streamed), at the rank's local
    # shapes: 8 of 32 heads, w_gate's (4096, 3584) shard
    serve_cfg = get_config("llama3-8b")
    L, hd = serve_cfg.num_layers, serve_cfg.head_dim
    serve_launches = dict.fromkeys(kernel_wrappers, 0)
    serve_routes = {n: {} for n in ("flash_attention_fwd", "stream_matmul")}
    serve_rows = []
    for rec in mesh_serve:
        tag = f"mesh {rec['cell']}"
        model_ranks = rec["mesh"][1]
        heads = serve_cfg.num_heads // model_ranks
        pre, ticks = rec["prefills"], rec["ticks"]
        if pre != len(MESH_SERVE_LENS) or ticks < MESH_SERVE_NEW:
            fail(f"{tag}: {pre} prefills and {ticks} ticks")
        outs = {int(k): v for k, v in rec["outputs"].items()}
        if sorted(outs) != list(range(pre)) or any(
                len(v) != MESH_SERVE_NEW or min(v) < 0
                or max(v) >= serve_cfg.vocab_size for v in outs.values()):
            fail(f"{tag}: outputs {outs}")
        streamed = "params/layers/w_gate" in rec["plan"]["offloaded"]
        if streamed != (rec["plan"]["hbm_budget"] is not None):
            fail(f"{tag}: plan {rec['plan']}")
        want = {"flash_attention_fwd": pre * L}
        if streamed:
            want["stream_matmul"] = (pre + ticks) * L
        launched = {n: c for n, c in rec["launches"].items() if c}
        if launched != want:
            fail(f"{tag}: launched {launched}, expected {want} (prefills "
                 f"{pre}, ticks {ticks}, {L} layers)")
        routes = rec["launches_by_route"]
        if routes["flash_attention_fwd"].get("wgmma") != want[
                "flash_attention_fwd"]:
            fail(f"{tag}: flash routes {routes['flash_attention_fwd']}")
        if streamed and routes["stream_matmul"].get("ring") != want[
                "stream_matmul"]:
            fail(f"{tag}: stream_matmul routes {routes['stream_matmul']}")
        q_at = sorted([1, n, heads, hd] for n in MESH_SERVE_LENS)
        if rec["kernel_shapes"]["flash_attention_fwd"] != q_at:
            fail(f"{tag}: flash launched at q "
                 f"{rec['kernel_shapes']['flash_attention_fwd']}, not {q_at}")
        w_local = [serve_cfg.d_model, serve_cfg.d_ff // model_ranks]
        rows = MESH_SERVE_SLOTS // rec["mesh"][0]
        x_at = sorted([[n, serve_cfg.d_model], w_local]
                      for n in set(MESH_SERVE_LENS) | {rows})
        if streamed and rec["kernel_shapes"]["stream_matmul"] != x_at:
            fail(f"{tag}: stream_matmul launched at "
                 f"{rec['kernel_shapes']['stream_matmul']}, not {x_at}")
        shard_bytes = w_local[0] * w_local[1] * 2
        if rec["stream_matmul_h2d_bytes"] != want.get("stream_matmul", 0) * \
                shard_bytes:
            fail(f"{tag}: stream_matmul streamed "
                 f"{rec['stream_matmul_h2d_bytes']} bytes")
        pool = rec["pool"]
        n_ranks = rec["world"]
        if (pool["local_device_bytes"] + pool["local_host_bytes"]) * n_ranks \
                != pool["device_bytes"] + pool["host_bytes"]:
            fail(f"{tag}: the rank's pool is not 1/{n_ranks} of it: {pool}")
        for n, c in rec["launches"].items():
            serve_launches[n] += c
        for n, rs in routes.items():
            for r, c in rs.items():
                serve_routes[n][r] = serve_routes[n].get(r, 0) + c
        link = rec["tick_link_bytes"]
        row = {k: rec[k] for k in (
            "cell", "mesh", "world", "plan", "param_bytes_by_tier", "pool",
            "prefills", "ticks", "launches_by_route", "kernel_shapes",
            "embed_rows_h2d_bytes", "gather_param_h2d_bytes",
            "max_memory_allocated", "add_tenant_s", "run_s", "seconds")}
        row.update(
            launches={n: c for n, c in rec["launches"].items() if c},
            h2d_bytes_per_tick=statistics.median(
                t["pool_h2d"] + t["stream_matmul_h2d"] for t in link),
            d2h_bytes_per_tick=statistics.median(t["pool_d2h"] for t in link),
            tick_ms_median=statistics.median(rec["tick_ms"]),
            tick_ms_range=[min(rec["tick_ms"]), max(rec["tick_ms"])],
            prefill_ms=rec["prefill_ms"],
            note="one rank's shard on a fake world (collectives dispatched, "
                 "not run): a tick time of that rank's work, not a serving "
                 "rate", card=card_line)
        emit("mesh_serve", **row)
        serve_rows.append(row)
    # the enc-dec serving cells: whisper-large-v3 as one rank's shard; B1
    # once a decoder layer of every prefill whose local query block is not
    # empty (the heads split: every prefill at 5 of 20 heads; the sequence
    # split over 8: rank 4's block of each prompt, none of the 4-token one),
    # at the local q, k and query offset; B2, where decoder/w_in and the
    # token table are in the host tier, once a decoder layer of every pass
    # on the rank's pinned (1280, 1280) w_in shard and once a pass on the
    # tied head's pinned table, all on the ring
    wcfg_mesh = get_config("whisper-large-v3")
    wL, whd, wheads = wcfg_mesh.num_layers, wcfg_mesh.head_dim, wcfg_mesh.num_heads
    wd, wV = wcfg_mesh.d_model, wcfg_mesh.vocab_size
    # the plan of serve_whisper_1x4_spill, as plan_offload gives it here on
    # the CPU for the same inventory and budget
    spill_plan = {"offloaded": {"params/pos_embed", "params/tok_embed",
                                "params/enc_pos_embed", "kv/cross_k",
                                "kv/cross_v", "kv/k", "kv/v",
                                "params/decoder/w_in"},
                  "resident_bytes": 2519214080, "host_bytes": 2000460800}
    encdec_rows, encdec_largest = [], []
    for rec in mesh_json["serve_encdec"]:
        tag = f"mesh {rec['cell']}"
        model_ranks, rank = rec["mesh"][1], rec["rank"]
        pre, ticks = rec["prefills"], rec["ticks"]
        if pre != len(MESH_ENCDEC_LENS) or ticks != MESH_ENCDEC_NEW - 1:
            fail(f"{tag}: {pre} prefills and {ticks} ticks")
        outs = {int(k): v for k, v in rec["outputs"].items()}
        if sorted(outs) != list(range(pre)) or any(
                len(v) != MESH_ENCDEC_NEW or min(v) < 0 or max(v) >= wV
                for v in outs.values()):
            fail(f"{tag}: outputs {outs}")
        pol = rec["policy"]
        split_heads = wheads % model_ranks == 0
        if (pol["head_sharded"], pol["seq_parallel_attn"]) != (
                split_heads, not split_heads):
            fail(f"{tag}: policy {pol}")
        plan = rec["plan"]
        streamed = plan is not None
        if streamed and (set(plan["offloaded"]) != spill_plan["offloaded"]
                         or plan["partial"]
                         or plan["resident_bytes"] != spill_plan["resident_bytes"]
                         or plan["host_bytes"] != spill_plan["host_bytes"]):
            fail(f"{tag}: plan {plan}, not {spill_plan}")
        # the rank's query block of an n-token prompt: whole at its local
        # heads under the head split; under the sequence split the block
        # torch.chunk gives it, at its first position
        blocks = []
        for n in MESH_ENCDEC_LENS:
            if split_heads:
                blocks.append([[1, n, wheads // model_ranks, whd],
                               [1, n, wheads // model_ranks, whd], 0])
                continue
            c = -(-n // model_ranks)
            if rank * c < n:
                blocks.append([[1, min(c, n - rank * c), wheads, whd],
                               [1, n, wheads, whd], rank * c])
        want = {"flash_attention_fwd": len(blocks) * wL}
        table_rows = [1, MESH_ENCDEC_SLOTS]     # a prefill's last token, a tick
        if streamed:
            want["stream_matmul"] = (pre + ticks) * (wL + 1)
        launched = {n: c for n, c in rec["launches"].items() if c}
        if launched != want:
            fail(f"{tag}: launched {launched}, expected {want} ({len(blocks)} "
                 f"prefills with a local query block, {ticks} ticks, {wL} "
                 f"layers{', the tied head' if streamed else ''})")
        routes = rec["launches_by_route"]
        if routes["flash_attention_fwd"].get("wgmma") != want[
                "flash_attention_fwd"]:
            fail(f"{tag}: flash routes {routes['flash_attention_fwd']}")
        if streamed and routes["stream_matmul"].get("ring") != want[
                "stream_matmul"]:
            fail(f"{tag}: stream_matmul routes {routes['stream_matmul']}")
        if rec["kernel_shapes"]["flash_attention_fwd"] != sorted(blocks):
            fail(f"{tag}: flash launched at "
                 f"{rec['kernel_shapes']['flash_attention_fwd']}, not {blocks}")
        w_local = [wd, wcfg_mesh.d_ff // model_ranks]
        x_at = sorted([[n, wd], w_local] for n in
                      set(MESH_ENCDEC_LENS) | {MESH_ENCDEC_SLOTS})
        x_at += sorted([[n, wd], [wd, wV]] for n in table_rows)
        if streamed and rec["kernel_shapes"]["stream_matmul"] != sorted(x_at):
            fail(f"{tag}: stream_matmul launched at "
                 f"{rec['kernel_shapes']['stream_matmul']}, not {x_at}")
        if rec["stream_matmul_h2d_bytes"] != (
                (pre + ticks) * (wL * w_local[0] * w_local[1] + wd * wV) * 2
                if streamed else 0):
            fail(f"{tag}: stream_matmul streamed "
                 f"{rec['stream_matmul_h2d_bytes']} bytes")
        # the rank's pool: its part of the self K/V's sequence, the cross
        # K/V whole on every model rank
        pool = rec["pool"]
        cross = 2 * wL * MESH_ENCDEC_SLOTS * wcfg_mesh.encoder_seq * \
            wcfg_mesh.num_kv_heads * whd * 2
        self_kv = pool["device_bytes"] + pool["host_bytes"] - cross
        if pool["local_device_bytes"] + pool["local_host_bytes"] != \
                self_kv // model_ranks + cross:
            fail(f"{tag}: the rank's pool is not its part of the self K/V "
                 f"and the whole cross K/V: {pool}")
        if streamed != (pool["device_bytes"] == 0):
            fail(f"{tag}: pool {pool} under plan {plan}")
        for n, c in rec["launches"].items():
            serve_launches[n] += c
        for n, rs in routes.items():
            for r, c in rs.items():
                serve_routes[n][r] = serve_routes[n].get(r, 0) + c
        encdec_largest.append(max(blocks, key=lambda b: b[0][1]))
        link = rec["tick_link_bytes"]
        row = {k: rec[k] for k in (
            "cell", "arch", "mesh", "rank", "world", "coords", "plan",
            "param_bytes_by_tier", "pool", "prefills", "ticks",
            "launches_by_route", "kernel_shapes", "embed_rows_h2d_bytes",
            "max_memory_allocated", "init_s", "seconds")}
        row.update(
            launches=launched,
            launch_formula=(f"flash = {len(blocks)} prefills with a local "
                            f"query block x {wL}"
                            + (f"; stream_matmul = ({pre} prefills + {ticks} "
                               f"ticks) x ({wL} w_in + 1 tied head)"
                               if streamed else "")),
            h2d_bytes_per_tick=statistics.median(
                t["pool_h2d"] + t["stream_matmul_h2d"] for t in link),
            d2h_bytes_per_tick=statistics.median(t["pool_d2h"] for t in link),
            tick_ms_median=statistics.median(rec["tick_ms"]),
            tick_ms_range=[min(rec["tick_ms"]), max(rec["tick_ms"])],
            prefill_ms=rec["prefill_ms"],
            note="one rank's shard on a fake world (collectives dispatched, "
                 "not run): a tick time of that rank's work, not a serving "
                 "rate", card=card_line)
        emit("mesh_serve", **row)
        encdec_rows.append(row)
    if not serve_launches["stream_matmul"]:
        fail("mesh: stream_matmul was launched no time on the serving cells")
    # B1 and B2 at the serving cells' local shapes against their plain
    # versions: the longest prompt's prefill at 8 of 32 heads, and w_gate's
    # pinned (4096, 3584) shard at a tick's 4 rows and that prefill's rows
    serve_flash = [flash_case(heads, max(MESH_SERVE_LENS), hd, "bfloat16",
                              True)]
    serve_stream = [stream_case(n, serve_cfg.d_model,
                                serve_cfg.d_ff // 4, "bfloat16", "bfloat16",
                                "pinned")
                    for n in (MESH_SERVE_SLOTS, max(MESH_SERVE_LENS))]
    # B1 and B2 at the enc-dec cells' local shapes: each cell's largest
    # query block (the heads split: 5 of 20 heads x 224 tokens; the sequence
    # split: 28 queries at offset 112 over the 224 keys that the attention
    # gathers, 20 heads), w_in's pinned (1280, 1280) shard at a tick's 4 rows
    # and the longest prefill's 224, and the tied head's pinned table at a
    # tick's rows
    encdec_flash = [dict(flash_case(q[0] * q[2], q[1], q[3], "bfloat16", True,
                                    Sk=k[1], q_offset=off), cell=row["cell"])
                    for (q, k, off), row in zip(encdec_largest, encdec_rows)]
    encdec_stream = [stream_case(n, wd, wcfg_mesh.d_ff // 4, "bfloat16",
                                 "bfloat16", "pinned")
                     for n in (MESH_ENCDEC_SLOTS, max(MESH_ENCDEC_LENS))]
    encdec_stream.append(stream_case(MESH_ENCDEC_SLOTS, wd, wV, "bfloat16",
                                     "bfloat16", "pinned", transposed=True))
    # B1 / B3 / B4 at the local shapes the mesh gave them, against their
    # plain versions: llama3-8b's 2 of 32 heads a device (prefill rows 2,
    # training parts of 2 sequences), gpt2-124m's whole 12 heads of 8
    # sequences; qwen2-vl's 4 of 64 heads over the whole 32,768 tokens
    # (Megatron SP); the last sequence-parallel rank's query block at its
    # offset over the whole sequence: starcoder2-7b's prefill (2 sequences x
    # 36 heads, 2,048 queries at 30,720 of 32,768 keys), its training block
    # (16 sequences x 36 heads, 256 queries at 3,840 of 4,096) and
    # whisper-large-v3's decoder's (8 sequences x 20 heads, head dim 64)
    mesh_flash = [flash_case(4, 32768, 128, "bfloat16", True),
                  flash_case(8, 32768, 128, "bfloat16", True),
                  dict(flash_case(72, 2048, 128, "bfloat16", True, Sk=32768,
                                  q_offset=30720), arch="starcoder2-7b")]
    mesh_flash_train = [dict(flash_train_case(bh, 4096, hd, "bfloat16", True),
                             arch=arch)
                        for arch, bh, hd in (("llama3-8b", 4, 128),
                                             ("gpt2-124m", 96, 64))]
    mesh_flash_train += [dict(flash_train_case(bh, 256, hd, "bfloat16", True,
                                               Sk=4096, q_offset=3840),
                              arch=arch)
                         for arch, bh, hd in (("starcoder2-7b", 576, 128),
                                              ("whisper-large-v3", 160, 64))]
    # B6 at the local shapes of the MoE cells (their forwards as the cells
    # launched them: granite-moe's 2 of 32 experts at 8 groups x 1,280
    # capacity rows, phi3.5-moe's 1 of 16 at 8 x 1,280 and at the decode's 8
    # rows), and dx / dw at the training rows, against its plain version
    # with torch.bmm as the library call
    mesh_gmm = [dict(gmm_case(E, M, K, N, "bfloat16", "device", shared=shared),
                     cells=mesh_gmm_shapes[(E, M, K, N, shared)])
                for E, M, K, N, shared in sorted(mesh_gmm_shapes)]
    if [c["route"] for c in mesh_gmm] != ["wgmma"] * len(mesh_gmm):
        fail(f"grouped_matmul at the mesh's local shapes took "
             f"{[c['route'] for c in mesh_gmm]}, not wgmma")
    mesh_gmm_bwd = [gmm_bwd_case(which, E, M, K, N)
                    for E, M, K, N, _ in sorted(mesh_gmm_train)
                    for which in ("dx", "dw")]
    # B5 at the local shapes of the SSM cells, against its plain version:
    # mamba2-130m's one sequence a device at all 24 heads, zamba2-1.2b's 4
    # of 64 heads at its training part's rows and at the prefill's 2 rows of
    # 32,768 tokens (from the cache's initial state, as the prefill runs it)
    mesh_ssd = [dict(ssd_case(B, S, nh, hp, N, "bfloat16", with_state=init),
                     cells=mesh_ssd_shapes[(B, S, nh, hp, N, init)])
                for B, S, nh, hp, N, init in sorted(mesh_ssd_shapes)]
    emit("mesh", card=card_line, cells=len(mesh_rows),
         serve_cells=len(serve_rows) + len(encdec_rows),
         launches_serve=serve_launches,
         launches_by_route_serve=serve_routes,
         seconds=time.time() - t_mesh, launches=mesh_launches,
         launches_by_route=mesh_routes,
         note="one device's shard under a fake world: collectives counted "
              "by the bytes each device's would move, not run; FLOP ratios "
              "to the reference's committed anchors are printed, not gated "
              "(an eager count against compiled HLO)",
         kernels_at_local_shapes={
             "flash_attention_fwd": [{k: c[k] for k in (
                 "shape", "dtype", "route", "max_abs_err", "rel_err", "tol",
                 "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "q_offset", "library", "library_rel_err")
                 if k in c} for c in mesh_flash],
             "flash_attention_train": mesh_flash_train,
             "grouped_matmul": mesh_gmm,
             "grouped_matmul_backward": mesh_gmm_bwd,
             "ssd_scan": mesh_ssd,
             "flash_attention_fwd_serve": serve_flash,
             "stream_matmul_serve": serve_stream,
             "flash_attention_fwd_serve_encdec": encdec_flash,
             "stream_matmul_serve_encdec": encdec_stream})

    # ------------------------------------------------------------- summary
    def train_summary(c, key, errs, lib):
        """One kernel's figures from a flash_train_case row."""
        return {
            **{k: c[k] for k in ("q_offset", "library") if k in c},
            "shape": c["shape"], "dtype": c["dtype"],
            "route": c["fwd_stats_route" if key == "fwd_stats" else "bwd_route"],
            "max_abs_err": max(c["errors"][e]["max_abs_err"] for e in errs),
            "tol": max(c["errors"][e]["tol"] for e in errs),
            "ms": c[f"{key}_ms"], "cold_ms": c[f"{key}_cold_ms"],
            "plain_ms": c[f"{key}_plain_ms"], "bound_ms": c[f"{key}_bound_ms"],
            "bound_by": c[f"{key}_bound_by"], "library_ms": c[lib]}

    head, shead, ssd_head = cases[0], stream_cases[0], ssd_cases[0]
    gmm_head, gmm_prefill, gmm_pinned = gmm_cases[0], gmm_cases[2], gmm_cases[3]
    print(json.dumps({"kernels": [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
        "replaces": "src/repro/kernels/flash_attention.py:302",
        "launches": main_path_launches["flash_attention_fwd"],
        "launches_by_route": main_path_routes["flash_attention_fwd"],
        "shape": head["shape"], "dtype": head["dtype"],
        "max_abs_err": max(c["max_abs_err"] for c in cases + mesh_flash
                           + serve_flash + encdec_flash),
        "ms": head["ms"], "cold_ms": head["cold_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "launches_encdec": encdec_launches["flash_attention_fwd"],
        "launches_vlm": vlm_launches["flash_attention_fwd"],
        "launches_cluster": cluster_launches["flash_attention_fwd"],
        "launches_by_route_cluster": cluster_routes["flash_attention_fwd"],
        "launches_dryrun": dry_launches["flash_attention_fwd"],
        "launches_by_route_dryrun": dry_routes["flash_attention_fwd"],
        "launches_serve_starcoder2": starcoder2_launches["flash_attention_fwd"],
        "launches_by_route_serve_starcoder2":
            starcoder2_routes["flash_attention_fwd"],
        "launches_serve_command_r": command_r_launches["flash_attention_fwd"],
        "launches_by_route_serve_command_r":
            command_r_routes["flash_attention_fwd"],
        "launches_moe_full": moe_full_launches["flash_attention_fwd"],
        "launches_by_route_moe_full": moe_full_routes["flash_attention_fwd"],
        "launches_mesh": mesh_launches["flash_attention_fwd"],
        "launches_by_route_mesh": mesh_routes["flash_attention_fwd"],
        "launches_mesh_serve": serve_launches["flash_attention_fwd"],
        "launches_by_route_mesh_serve": serve_routes["flash_attention_fwd"],
        "launches_mesh_serve_by_cell": {
            r["cell"]: r["launches"].get("flash_attention_fwd", 0)
            for r in serve_rows + encdec_rows},
        "mesh_serve_local": [{k: c[k] for k in (
            "cell", "shape", "dtype", "route", "max_abs_err", "rel_err", "tol",
            "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "q_offset", "library") if k in c}
            for c in serve_flash + encdec_flash],
        "mesh_local": [{k: c[k] for k in (
            "shape", "dtype", "route", "max_abs_err", "rel_err", "tol", "ms",
            "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "q_offset", "library") if k in c} for c in mesh_flash],
        "dryrun_prefill_32k": {k: long_flash_case[k] for k in (
            "shape", "dtype", "route", "max_abs_err", "rel_err", "tol", "ms",
            "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        **{f"{name}_prefill": {k: case[k] for k in (
            "shape", "dtype", "ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")}
           for name, case in (("encdec", encdec_case), ("vlm", vlm_case))},
        **{key: [{k: case[k] for k in (
            "shape", "dtype", "route", "max_abs_err", "rel_err", "tol", "ms",
            "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                 for case in group]
           for key, group in (("hd96", hd96_cases),
                              ("cluster_prefill", cluster_cases),
                              ("serve_full_arch_prefill", full_arch_cases))},
    }, {
        "name": "stream_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stream_matmul.cu",
        "replaces": "src/repro/kernels/stream_matmul.py:55",
        "launches": rt_launches["stream_matmul"],
        "launches_by_route": rt_stream_routes,
        "shape": shead["shape"], "dtype": shead["x"], "w": shead["where"],
        "route_at_shape": shead["route"],
        "max_abs_err": max(c["max_abs_err"] for c in stream_cases
                           + serve_stream + encdec_stream),
        "ms": shead["kernel_ms"], "cold_ms": shead["cold_ms"],
        "plain_ms": shead["plain_ms"],
        "bound_ms": shead["bound_ms"], "bound_by": shead["bound_by"],
        "library_ms": shead["library_ms"],
        "library_device_w_ms": shead["library_device_w_ms"],
        "link_share": shead["link_share"],
        "host_link_peak_gb_per_s": HOST_LINK_BYTES_PER_S / 1e9,
        "host_link_measured_gb_per_s": link_bytes_per_s / 1e9,
        "link_memcpy_gb_per_s": link_bytes_per_s / 1e9,
        "link_memcpy_caching_allocator_gb_per_s": link_alloc_bytes_per_s / 1e9,
        "launches_dryrun": dry_launches["stream_matmul"],
        "launches_mesh_serve": serve_launches["stream_matmul"],
        "launches_by_route_mesh_serve": serve_routes["stream_matmul"],
        "launches_mesh_serve_by_cell": {
            r["cell"]: r["launches"].get("stream_matmul", 0)
            for r in serve_rows + encdec_rows},
        "mesh_serve_local": [{k: c[k] for k in (
            "shape", "transposed", "route", "max_abs_err", "rel_err", "tol",
            "kernel_ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "link_share", "h2d_gb_per_s")}
            for c in serve_stream + encdec_stream],
        "launches_vlm": vlm_launches["stream_matmul"],
        "launches_by_route_vlm": vlm_stream_routes,
        **{f"vlm_{name}": {k: case[k] for k in (
            "shape", "route", "max_abs_err", "rel_err", "tol", "kernel_ms",
            "cold_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "link_share", "h2d_gb_per_s")}
           for name, case in zip(("decode", "prefill"), vlm_stream_cases)},
    }] + [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": train_launches[name],
        **({"launches_by_route": train_routes[name]} if name in train_routes
           else {}),
        "shape": train_cases[0]["shape"], "dtype": train_cases[0]["dtype"],
        "max_abs_err": max(c["errors"][e]["max_abs_err"]
                           for c in train_cases + mesh_flash_train
                           for e in errs),
        "ms": train_cases[0][f"{key}_ms"],
        "cold_ms": train_cases[0][f"{key}_cold_ms"],
        "plain_ms": train_cases[0][f"{key}_plain_ms"],
        "bound_ms": train_cases[0][f"{key}_bound_ms"],
        "bound_by": train_cases[0][f"{key}_bound_by"],
        "library_ms": train_cases[0][lib],
        "launches_train_hybrid": thyb_launches[name],
        "launches_train_moe": tmoe_launches[name],
        "launches_dryrun": dry_launches[name],
        "launches_by_route_dryrun": dry_routes[name],
        "launches_train_phi3": tphi_launches[name],
        "launches_by_route_train_phi3": tphi_routes[name],
        "hd96": [train_summary(c, key, errs, lib) for c in hd96_train_cases],
        "train_phi3": train_summary(phi3_train_case, key, errs, lib),
        "dryrun_train_4k": [dict(train_summary(c, key, errs, lib), arch=c["arch"])
                            for c in path_flash],
        "launches_mesh": mesh_launches[name],
        "launches_by_route_mesh": mesh_routes[name],
        "launches_mesh_serve": serve_launches[name],
        "mesh_local": [dict(train_summary(c, key, errs, lib), arch=c["arch"])
                       for c in mesh_flash_train],
    } for name, source, replaces, key, errs, lib in (
        ("flash_attention_fwd_stats",
         "src/repro_torch/kernels/csrc/flash_attention_fwd.cu",
         "src/repro/kernels/flash_attention.py:93", "fwd_stats", ("out", "lse"),
         "fwd_stats_library_ms"),
        ("flash_attention_bwd_dkdv",
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:242", "dkdv", ("dk", "dv"),
         "bwd_library_ms"),
        ("flash_attention_bwd_dq",
         "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
         "src/repro/kernels/flash_attention.py:267", "dq", ("dq",),
         "bwd_library_ms"))] + [{
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "launches": ssm_launches["ssd_scan"],
        "shape": ssd_head["shape"], "N": ssd_head["N"],
        "dtype": ssd_head["dtype"],
        "max_abs_err": max(c["max_abs_err"] for c in ssd_cases + mesh_ssd),
        "ms": ssd_head["ms"], "cold_ms": ssd_head["cold_ms"],
        "plain_ms": ssd_head["plain_ms"],
        "bound_ms": ssd_head["bound_ms"], "bound_by": ssd_head["bound_by"],
        "bound_fma_ms": ssd_head["bound_fma_ms"],
        "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan",
        "launches_train_ssm": tssm_launches["ssd_scan"],
        "launches_train_hybrid": thyb_launches["ssd_scan"],
        "launches_dryrun": dry_launches["ssd_scan"],
        "launches_mesh": mesh_launches["ssd_scan"],
        "launches_mesh_serve": serve_launches["ssd_scan"],
        "mesh_local": [{k: c[k] for k in (
            "shape", "N", "init_state", "max_abs_err", "rel_err", "tol",
            "state_rel_err", "ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "cells")} for c in mesh_ssd],
        "dryrun_prefill_32k": {k: path_ssd[k] for k in (
            "shape", "N", "dtype", "max_abs_err", "rel_err", "tol",
            "state_rel_err", "ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by")},
        "function_backward": ssd_bwd_cases,
    }, {
        "name": "grouped_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/grouped_matmul.cu",
        "replaces": "src/repro/kernels/moe_gmm.py:54",
        "launches": moe_launches["grouped_matmul"],
        "launches_moe_runtime": mrt_launches["grouped_matmul"],
        "launches_by_route": moe_routes["grouped_matmul"],
        "launches_by_route_moe_runtime": mrt_routes["grouped_matmul"],
        "shape": gmm_head["shape"], "dtype": gmm_head["dtype"],
        "w": gmm_head["where"], "x_expert_stride": gmm_head["x_expert_stride"],
        "max_abs_err": max(c["max_abs_err"] for c in gmm_cases + mesh_gmm
                           + mesh_gmm_bwd),
        "ms": gmm_head["ms"], "cold_ms": gmm_head["cold_ms"],
        "plain_ms": gmm_head["plain_ms"],
        "bound_ms": gmm_head["bound_ms"], "bound_by": gmm_head["bound_by"],
        "library_ms": gmm_head["library_ms"], "library": "torch.bmm",
        "pinned": {k: gmm_pinned[k] for k in (
            "shape", "route", "ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "h2d_gb_per_s")},
        "prefill": {k: gmm_prefill[k] for k in (
            "shape", "route", "ms", "cold_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")},
        "launches_train_moe": tmoe_launches["grouped_matmul"],
        "launches_by_route_train_moe": tmoe_routes["grouped_matmul"],
        "launches_dryrun": dry_launches["grouped_matmul"],
        "launches_by_route_dryrun": dry_routes["grouped_matmul"],
        "launches_moe_full": moe_full_launches["grouped_matmul"],
        "launches_by_route_moe_full": moe_full_routes["grouped_matmul"],
        "moe_full_shapes": [{k: c[k] for k in (
            "shape", "where", "host_buffer", "x_expert_stride", "route",
            "max_abs_err", "rel_err", "tol", "ms", "cold_ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "h2d_gb_per_s",
            "link_share")} for c in phi35_gmm_cases],
        "moe_full_panel_depths": gmm_phi35_depths,
        "backward": gmm_bwd_cases,
        "dryrun_train_4k": [{k: c[k] for k in (
            "shape", "route", "max_abs_err", "rel_err", "tol", "ms", "cold_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")} for c in path_gmm],
        "dryrun_train_4k_backward": path_gmm_bwd,
        "launches_mesh": mesh_launches["grouped_matmul"],
        "launches_by_route_mesh": mesh_routes["grouped_matmul"],
        "launches_mesh_serve": serve_launches["grouped_matmul"],
        "mesh_local": [{k: c[k] for k in (
            "shape", "x_expert_stride", "route", "max_abs_err", "rel_err",
            "tol", "ms", "cold_ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "cells")} for c in mesh_gmm],
        "mesh_local_backward": mesh_gmm_bwd,
    }]}), flush=True)
    print(card_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
