"""The port's mesh and sharding layer (``repro_torch.launch.mesh``,
``models.common``'s ``AxisEnv`` / ``ShardingPolicy`` / specs, the sharded
step) against the reference's.

* Spec trees: for every arch under the 16 x 16 and 2 x 16 x 16 axis
  environments, the parameter, batch, cache and AdamW specs equal the
  reference's ``PartitionSpec``s leaf by leaf (no mesh is needed).
* Numerics over real collectives: spawned gloo ranks (a ``FileStore`` under
  ``tmp_path``, each world with its own timeout) run the sharded step on the
  reference's weights. The fp32 loss is held within 5e-3 of the reference's
  single-device loss (the bound of the reference's own sharded test,
  ``tests/test_sharding.py``) and within 1e-5 (relative) of the port's
  unsharded loss; every gradient leaf, gathered whole, within 1e-5 of the
  largest value of the unsharded gradients; one AdamW step keeps every
  placement; the collectives are the ZeRO-3 rule's. The MoE cases (granite
  reduced, 4 experts top-2) split the experts over "model" where it divides
  them: every rank routes whole rows, runs its own experts and the exit
  sums the ranks'; the router's gradient is held like every other leaf.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from port_parity import model_pair, to_jax, to_torch
from repro.configs import ALL_ARCHS, get_config as ref_get_config
from repro.configs.shapes import SHAPES as REF_SHAPES, applicable
from repro.models.common import AxisEnv as RefAxisEnv
from repro.models.model_zoo import build_model as ref_build_model
from repro.optim import adamw as ref_adamw
from repro_torch.configs import get_config
from repro_torch.configs.shapes import get_shape
from repro_torch.models.common import AxisEnv, tree_items, tree_leaves
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import unembed_spec
from repro_torch.optim import adamw
from repro_torch.optim import compression as port_comp
from repro_torch.train.train_step import _accumulate_grads

ENVS = {"16x16": (("data", "model"), {"data": 16, "model": 16}),
        "2x16x16": (("pod", "data", "model"), {"pod": 2, "data": 16, "model": 16})}
WORLD_TIMEOUT_S = 150
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "src")


# ------------------------------------------------------------ spec trees
def _ref_specs(tree):
    leaves = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, P))
    return [tuple(x) for x in leaves]


def _port_specs(tree):
    """Spec leaves in the reference's flattening order (a spec is a tuple,
    a leaf here; dicts and NamedTuples are nodes)."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return [tree]
    return [s for _, child in tree_items(tree) for s in _port_specs(child)]


@pytest.mark.parametrize("env_name", sorted(ENVS))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_spec_trees_equal_reference(arch, env_name):
    axes, sizes = ENVS[env_name]
    ref = ref_build_model(ref_get_config(arch), RefAxisEnv(axes, sizes))
    port = build_model(get_config(arch), AxisEnv(axes, sizes))
    assert port.pol.__dict__ == ref.pol.__dict__
    _, rspecs = ref.init(None, abstract=True)
    _, pspecs = port.init(abstract=True)
    assert _port_specs(pspecs) == _ref_specs(rspecs)
    assert _port_specs(adamw.state_specs(pspecs)) == _ref_specs(
        ref_adamw.state_specs(rspecs))
    for rshape in REF_SHAPES:
        if not applicable(ref.cfg, rshape)[0]:
            continue
        shape = get_shape(rshape.name)
        rb, pb = ref.batch_specs(rshape), port.batch_specs(shape)
        assert sorted(rb) == sorted(pb)
        for name in rb:
            assert tuple(rb[name][0]) == tuple(pb[name][0]), name
            assert tuple(rb[name][2]) == pb[name][2], (rshape.name, name)
        assert _port_specs(port.cache_specs(shape.global_batch)) == _ref_specs(
            ref.cache_specs(rshape.global_batch))


# ---------------------------------------------- numerics over gloo ranks
# starcoder2 with 3 heads and whisper with 3: no model axis of 2 or 4
# divides them, so their activations split by sequence (sequence-parallel
# attention); whisper's 30 encoder frames split 8, 8, 8, 6 over 4 ranks;
# qwen2-vl's 4 heads split over 4, its residuals by sequence (Megatron SP)
STARCODER2 = {"num_heads": 3, "num_kv_heads": 1}
WHISPER = {"num_heads": 3, "num_kv_heads": 3, "encoder_seq": 30}
# granite-moe reduced (4 experts, top-2): on (2, 2) heads, KV heads and
# experts split in two; on (1, 4) one head and one expert a rank with the KV
# heads whole (phi3.5-moe's layout on 16x16); with 3 heads and 1 KV head on
# (1, 4) the attention is sequence-parallel, so each rank gathers whole rows
# to route them; with 3 experts the experts stay whole on every rank, on
# (2, 2) while the heads split, on (1, 4) under sequence-parallel attention
# (each rank keeps its own tokens of the whole rows' output)
GRANITE_MOE = {"num_heads": 4, "num_kv_heads": 2, "num_experts": 4}
GRANITE_MOE_SP = {"num_heads": 3, "num_kv_heads": 1, "num_experts": 4}
# the SSM and hybrid families (reduced: d_inner 128, 8 SSM heads of 16):
# mamba2 is fsdp_only, one sequence a rank; zamba2 (4 heads, 2 KV heads)
# splits its SSM heads, heads and KV heads in two on (2, 2); on (1, 4) two
# SSM heads and one head a rank, the KV heads whole; with SSM heads of 64
# (two of them, which 4 does not divide) the SSM stays whole on every model
# rank while the attention heads split
ZAMBA2_SSM_WHOLE = {"ssm_head_dim": 64}
# name -> (arch, mesh shape, config overrides, global batch)
CASES = {"llama3_2x2": ("llama3-8b", (2, 2), {"num_heads": 4, "num_kv_heads": 2}, 4),
         "llama3_1x4": ("llama3-8b", (1, 4), {"num_heads": 4, "num_kv_heads": 2}, 4),
         "gpt2_2x2": ("gpt2-124m", (2, 2), {}, 4),
         "gpt2_2x2_b2": ("gpt2-124m", (2, 2), {}, 2),
         "starcoder2_2x2": ("starcoder2-7b", (2, 2), STARCODER2, 4),
         "starcoder2_1x4": ("starcoder2-7b", (1, 4), STARCODER2, 4),
         "qwen2vl_1x4": ("qwen2-vl-72b", (1, 4), {}, 4),
         "whisper_1x4": ("whisper-large-v3", (1, 4), WHISPER, 4),
         "granite_moe_2x2": ("granite-moe-1b-a400m", (2, 2), GRANITE_MOE, 4),
         "granite_moe_1x4": ("granite-moe-1b-a400m", (1, 4), GRANITE_MOE, 4),
         "granite_moe_1x4_sp": ("granite-moe-1b-a400m", (1, 4),
                                GRANITE_MOE_SP, 4),
         "granite_moe_2x2_e3": ("granite-moe-1b-a400m", (2, 2),
                                {**GRANITE_MOE, "num_experts": 3}, 4),
         "granite_moe_1x4_sp_e3": ("granite-moe-1b-a400m", (1, 4),
                                   {**GRANITE_MOE_SP, "num_experts": 3}, 4),
         "mamba2_2x2": ("mamba2-130m", (2, 2), {}, 4),
         "mamba2_1x4": ("mamba2-130m", (1, 4), {}, 4),
         "zamba2_2x2": ("zamba2-1.2b", (2, 2), {}, 4),
         "zamba2_1x4": ("zamba2-1.2b", (1, 4), {}, 4),
         "zamba2_1x4_ssm_whole": ("zamba2-1.2b", (1, 4), ZAMBA2_SSM_WHOLE, 4)}
SEQ = 16
# the policy each case runs under: (seq_parallel_attn, seq_residuals)
SEQ_SPLIT = {"starcoder2_2x2": (True, False), "starcoder2_1x4": (True, False),
             "qwen2vl_1x4": (False, True), "whisper_1x4": (True, False),
             "granite_moe_1x4_sp": (True, False),
             "granite_moe_1x4_sp_e3": (True, False)}
# the MoE cases whose model axis divides the experts
EXPERTS_SHARDED = {"granite_moe_2x2", "granite_moe_1x4", "granite_moe_1x4_sp"}
# the SSM / hybrid cases whose model axis divides the SSM heads
SSM_SHARDED = {"zamba2_2x2", "zamba2_1x4"}

# The ranks run in a script of their own (it imports the port alone, not
# this module, jax or the reference): ``python worker.py <dir> <job>``
# spawns 4 gloo ranks over a FileStore in <dir>.
_WORKER = textwrap.dedent("""\
    import os, sys
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def numerics(rank, out_dir, arch, mesh_shape, over, batch_size):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSuite
        from repro_torch.core.step_analysis import count_step
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.model_zoo import build_model, shard_tree
        from repro_torch.optim import adamw
        from repro_torch.train.train_step import (TrainStepConfig,
                                                  _accumulate_grads,
                                                  make_mesh_train_step)
        payload = torch.load(os.path.join(out_dir, "payload.pt"))
        cfg = get_config(arch).reduced().with_(remat="none", dtype="float32",
                                               **over)
        mesh = make_host_mesh(*mesh_shape)
        model = build_model(cfg, mesh)
        _, specs = model.init(abstract=True)
        params = shard_tree(payload["params"], specs, model.env)
        bspecs = {k: v[2] for k, v in model.batch_specs(
            ShapeSuite("t", "train", 16, batch_size)).items()}
        batch = shard_tree(payload["batch"], bspecs, model.env)
        (loss, grads), cost = count_step(_accumulate_grads, model, params,
                                         batch, 1)
        with torch.no_grad():
            _, fwd_cost = count_step(model.loss_fn, params, batch)
        same_layout = all(
            g.placements == p.placements
            for g, p in zip(tree_leaves(grads), tree_leaves(params)))
        full = [g.full_tensor() for g in tree_leaves(grads)]
        step = make_mesh_train_step(model, mesh, TrainStepConfig(), bspecs)
        opt = adamw.init(params)
        before = [p.placements for p in tree_leaves(params)]
        params, opt, metrics = step(params, opt, batch)
        kept = (before == [p.placements for p in tree_leaves(params)]
                == [m.placements for m in tree_leaves(opt.mu)]
                == [v.placements for v in tree_leaves(opt.nu)])
        if rank == 0:
            torch.save({"loss": float(loss), "grads": full,
                        "same_layout": same_layout, "kept": kept,
                        "step_loss": float(metrics["loss"]),
                        "counts": cost.collective_counts,
                        "fwd_counts": fwd_cost.collective_counts},
                       os.path.join(out_dir, "out.pt"))

    def pods(rank, out_dir):
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.optim import compression
        payload = torch.load(os.path.join(out_dir, "payload.pt"))
        mesh = make_host_mesh(1, 2, pod=2)
        pod = mesh.get_local_rank("pod")
        g, e = {"w": payload["grads"][pod]}, {"w": payload["errs"][pod]}
        mean, err = compression.cross_pod_sync(g, e, mesh)
        same, same_err = compression.cross_pod_sync(g, e, make_host_mesh(2, 2))
        torch.save({"mean": mean, "err": err, "same": same,
                    "same_err": same_err},
                   os.path.join(out_dir, f"rank{rank}.pt"))

    def serving(rank, out_dir, cases):
        # each case on its own mesh: the prefill (logits and cache), then
        # decode steps on a pool of max_seq holding the prefill cache
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSuite
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.common import (local, placements, tree_leaves,
                                               tree_unflatten)
        from repro_torch.models.model_zoo import build_model, shard_tree
        payload = torch.load(os.path.join(out_dir, "payload.pt"))
        full = lambda t: tree_unflatten(t, [x.full_tensor()
                                            for x in tree_leaves(t)])
        res, windows = {}, {}
        for name, (arch, mesh_shape, over) in cases.items():
            p = payload[name]
            cfg = get_config(arch).reduced().with_(remat="none",
                                                   dtype="float32", **over)
            mesh = make_host_mesh(*mesh_shape)
            model = build_model(cfg, mesh)
            env = model.env
            lay = lambda x, sp: distribute_tensor(x, mesh, placements(sp, env))
            _, specs = model.init(abstract=True)
            params = shard_tree(p["params"], specs, env)
            # the inputs over every position (tokens, or a VLM's embeds and
            # M-RoPE positions, whose sequence is dim 2): a window of them
            inputs, P, S_MAX = p["inputs"], p["prompt"], p["max_seq"]
            lead = inputs["tokens" if "tokens" in inputs else "embeds"]
            B, n_pos = lead.shape[0], lead.shape[1]

            def window(lo, hi, specs):
                return {k: lay(v.narrow(2 if k == "positions" else 1, lo,
                                        hi - lo), specs[k][2])
                        for k, v in inputs.items()}
            pre = model.batch_specs(ShapeSuite("p", "prefill", P, B))
            logits, _, cache = model.forward(
                params, window(0, P, pre),
                return_cache=True, last_token_only=True)
            got = {"prefill": logits.full_tensor(),
                   "prefill_cache": full(cache)}
            # K/V pasted at positions 0..P-1 of the pool, an SSM cache (its
            # conv window and state) whole
            pool = {}
            for k, v in got["prefill_cache"].items():
                if k == "ssm":
                    pool[k] = v
                    continue
                pool[k] = torch.zeros(v.shape[:2] + (S_MAX,) + v.shape[3:],
                                      dtype=v.dtype)
                pool[k][:, :, :P] = v
            pool = shard_tree(pool, model.cache_specs(B), env)
            dec = model.batch_specs(ShapeSuite("d", "decode", S_MAX, B))
            steps = []
            for pos in range(P, n_pos):
                out, new = model.decode(params, pool, {
                    **window(pos, pos + 1, dec),
                    "pos": lay(torch.tensor(pos, dtype=torch.int32),
                               dec["pos"][2])})
                assert new is pool
                steps.append(out.full_tensor())
            got["decode"] = steps
            got["pool"] = full(pool)
            pl = lambda t: [str(x) for x in t.placements]
            got["pool_placements"] = {
                k: ({f: pl(getattr(v, f)) for f in v._fields} if k == "ssm"
                    else pl(v)) for k, v in pool.items()}
            res[name] = got
            if "ssm" in pool:
                # this rank's conv windows: its batch rows, every channel
                windows[name] = (mesh.get_local_rank("data"),
                                 local(pool["ssm"].conv).clone())
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "out.pt"))
        torch.save(windows, os.path.join(out_dir, f"windows{rank}.pt"))

    def runtime(rank, out_dir, cases):
        # each case a SliceRuntime on its own mesh serving one tenant to the
        # end; a case whose payload holds weights gets them (the
        # reference's), distributed, in place of its own draw
        import numpy as np
        from repro_torch.configs import get_config
        from repro_torch.core.offload import _flatten_with_paths, place_tree
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import common, model_zoo
        from repro_torch.serving import Request, SliceRuntime, TenantSpec
        payload = torch.load(os.path.join(out_dir, "payload.pt"))
        own_init, own_on_host = model_zoo.Model.init, common.on_host

        def given(weights):
            def init(self, generator=None, *, abstract=False, placement=None):
                shapes, specs = own_init(self, abstract=True)
                if abstract:
                    return shapes, specs
                return model_zoo.shard_tree(weights, specs, self.env), specs
            return init

        res, outputs = {}, {}
        for name, (arch, mesh_shape, over, spec) in cases.items():
            p = payload[name]
            cfg = get_config(arch).reduced().with_(remat="none",
                                                   dtype="float32", **over)
            rt = SliceRuntime(mesh=make_host_mesh(*mesh_shape))
            if p.get("pool_only"):
                # a tenant TenantEngine does not serve on a mesh: its pool
                # alone, placed by the runtime's plan
                from repro_torch.core.slices import get_profile
                from repro_torch.serving import KVPool
                model = model_zoo.build_model(cfg, rt.mesh)
                spec_ = TenantSpec(name, cfg, **spec)
                plan = rt._plan(spec_, get_profile(spec_.profile), model,
                                model.init(abstract=True)[0])
                pool = KVPool(model, spec_.slots, spec_.max_seq, plan=plan)
                res[name] = {"split": pool.split_leaves,
                             "bytes": (pool.device_bytes, pool.host_bytes),
                             "plan_offloaded": plan.offloaded}
                continue
            if "params" in p:
                model_zoo.Model.init = given(p["params"])
            try:
                t = rt.add_tenant(TenantSpec(name, cfg, **spec))
            finally:
                model_zoo.Model.init = own_init
            rt.submit(name, [Request(i, np.asarray(prompt, np.int32), n)
                             for i, (prompt, n) in enumerate(p["requests"])])
            # the parameters the plan puts in the host tier are taken for
            # host-tier shards (on the CPU both tiers are one memory): those
            # gathered over an axis go through the copy before the gather
            host = {x.to_local().untyped_storage().data_ptr()
                    for path, x in _flatten_with_paths({"params": t.params})
                    if t.plan.is_offloaded(path)}
            common.on_host = lambda w: (
                common.is_dtensor(w)
                and w.to_local().untyped_storage().data_ptr() in host)
            common.gather_param.h2d_bytes = 0
            try:
                report = rt.run()["tenants"][name]
            finally:
                common.on_host = own_on_host
            pool = t.engine.pool
            cache = pool.materialize()
            # place_tree moves each leaf's local shard, keeping placements
            placed = place_tree({"params": t.params}, t.plan,
                                "cpu")["params"]
            kept = all(
                a.placements == b.placements and a.shape == b.shape
                and torch.equal(a.to_local(), b.to_local())
                for a, b in zip(common.tree_leaves(placed),
                                common.tree_leaves(t.params)))
            res[name] = {
                "place_tree_kept": kept,
                "outputs": t.engine.outputs, "report": report,
                "split": pool.split_leaves,
                "bytes": (pool.device_bytes, pool.host_bytes),
                "local_bytes": (pool.local_device_bytes,
                                pool.local_host_bytes),
                "host_params": len(host),
                "gathered_host_bytes": common.gather_param.h2d_bytes,
                "pool_placements": {k: [str(x) for x in cache[k].placements]
                                    for k in ("k", "v") if k in cache}}
            outputs[name] = t.engine.outputs
        # tenants a mesh does not serve raise, naming their ROADMAP items
        for arch in ("whisper-large-v3", "qwen2-vl-72b"):
            rt = SliceRuntime(mesh=make_host_mesh(1, 4))
            try:
                rt.add_tenant(TenantSpec(arch, get_config(arch).reduced()))
                res[arch] = None
            except NotImplementedError as e:
                res[arch] = str(e)
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "out.pt"))
        torch.save(outputs, os.path.join(out_dir, f"outputs{rank}.pt"))

    def rank_main(rank, out_dir, job):
        from repro_torch.launch.mesh import init_world
        init_world(rank, 4, "file://" + os.path.join(out_dir, "store"),
                   device_type="cpu", timeout_s=60)
        try:
            payload = torch.load(os.path.join(out_dir, "job.pt"))
            if job == "numerics":
                numerics(rank, out_dir, *payload)
            elif job == "serving":
                serving(rank, out_dir, payload)
            elif job == "runtime":
                runtime(rank, out_dir, payload)
            else:
                pods(rank, out_dir)
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=4)
    """)


def _world(tmp_path, job, args=(), worker=_WORKER) -> float:
    """Runs ``job`` of ``worker`` (this module's by default) on 4 spawned
    gloo ranks, under the world's timeout; returns the world's seconds."""
    torch.save(args, tmp_path / "job.pt")
    (tmp_path / "worker.py").write_text(worker)
    env = {**os.environ, "PYTHONPATH": SRC}
    t0 = time.time()
    out = subprocess.run([sys.executable, str(tmp_path / "worker.py"),
                          str(tmp_path), job], capture_output=True, text=True,
                         env=env, timeout=WORLD_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-3000:]
    return time.time() - t0


def _train_batch(cfg, batch_size: int):
    """A training batch of ``SEQ`` tokens a sequence: token ids for the
    decoder-only archs, M-RoPE embeddings of 2 text tokens, a 2 x 3 image
    and 8 text tokens for the VLM, ``encoder_seq`` frames for the enc-dec;
    the labels the next tokens."""
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size,
                        size=(batch_size, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        from test_torch_vlm import vlm_positions
        pos = vlm_positions(2, 2, 3, 8)
        assert pos.shape[1] == SEQ
        del batch["tokens"]
        batch["embeds"] = (0.02 * rng.standard_normal(
            (batch_size, SEQ, cfg.d_model))).astype(np.float32)
        batch["positions"] = np.repeat(pos[:, None], batch_size, axis=1)
    elif cfg.family == "encdec":
        batch["frames"] = (0.02 * rng.standard_normal(
            (batch_size, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return batch


def _dropped(pm, pp, batch, monkeypatch) -> int:
    """The assignments the unsharded port's MoE layers drop at capacity in
    one forward of ``batch``."""
    from repro_torch.models import moe as moe_mod
    slots, seen = moe_mod._slots, []

    def watched(cfg, top_w, top_e, C):
        out = slots(cfg, top_w, top_e, C)
        seen.append(int((out[2] == cfg.num_experts * C).sum()))
        return out
    monkeypatch.setattr(moe_mod, "_slots", watched)
    with torch.no_grad():
        pm.loss_fn(pp, batch)
    monkeypatch.setattr(moe_mod, "_slots", slots)
    assert len(seen) == pm.cfg.num_layers
    return sum(seen)


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_loss_and_grads_match_reference(case, tmp_path, monkeypatch,
                                                request):
    """llama3 (4 heads, 2 KV heads, as the reference's sharded test) on
    (2, 2) and on (1, 4), where the model axis does not divide the KV heads
    (they stay whole and each rank's query heads read theirs); gpt2 on
    (2, 2), the fsdp_only profile: at batch 4 the model axis is a batch
    axis; at batch 2 it is not, so the logits split their tokens over it
    (``unembed_spec``), the labels follow, and the head's gradient is a
    part per model rank. starcoder2 (3 heads, 1 KV head) on (2, 2) and
    (1, 4) and whisper (3 heads) on (1, 4): sequence-parallel attention,
    each rank's K/V gathered and its queries attending at their offset,
    whisper's encoder frames split unevenly; qwen2-vl on (1, 4): Megatron
    SP, the residual stream split by sequence between tensor-parallel
    regions entered by an all-gather and left by a reduce-scatter.
    granite-moe: the experts split over "model" (``EXPERTS_SHARDED``) or
    whole on every rank, the routing on whole rows (gathered under
    sequence-parallel attention), assignments dropped at capacity (the
    same on the mesh: its loss and gradients would part otherwise)."""
    arch, mesh_shape, over, batch_size = CASES[case]
    rm, rp, pm, pp = model_pair(arch, dtype="float32", **over)
    env = AxisEnv(("data", "model"), dict(zip(("data", "model"), mesh_shape)))
    pol = build_model(pm.cfg, env).pol
    if pm.cfg.family == "moe":
        assert pol.experts_sharded == (case in EXPERTS_SHARDED)
    if pm.cfg.family in ("ssm", "hybrid"):
        assert pol.ssm_sharded == (case in SSM_SHARDED)
        assert pol.profile == ("fsdp_only" if pm.cfg.family == "ssm" else "tp")
    if case == "gpt2_2x2_b2":
        assert pol.profile == "fsdp_only"
        assert unembed_spec(env, pol, batch_size) == ("data", "model")
    assert (pol.seq_parallel_attn, pol.seq_residuals) == SEQ_SPLIT.get(
        case, (False, False))
    batch = _train_batch(pm.cfg, batch_size)
    ref_loss = float(rm.loss_fn(rp, {k: to_jax(v) for k, v in batch.items()}))
    pbatch = {k: to_torch(v) for k, v in batch.items()}
    if pm.cfg.family == "moe":
        # reduced granite's capacity, 10 slots an expert for a row's 32
        # assignments (13 with 3 experts), drops some in every case
        assert _dropped(pm, pp, pbatch, monkeypatch) > 0
    want_loss, want = _accumulate_grads(pm, pp, pbatch, 1)
    torch.save({"params": pp, "batch": pbatch}, tmp_path / "payload.pt")
    # the world's seconds go to the junit report, beside its timeout
    request.node.user_properties.append(("world_s", round(_world(
        tmp_path, "numerics", (arch, mesh_shape, over, batch_size)), 1)))
    out = torch.load(tmp_path / "out.pt")
    assert abs(out["loss"] - ref_loss) / abs(ref_loss) < 5e-3
    assert abs(out["loss"] - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    assert out["step_loss"] == out["loss"]
    want = list(tree_leaves(want))
    top = max(float(g.abs().max()) for g in want)
    for got, w in zip(out["grads"], want):
        assert got.shape == w.shape
        assert float((got - w).abs().max()) <= 1e-5 * top
    assert out["same_layout"] and out["kept"]
    if arch == "llama3-8b" and mesh_shape == (2, 2):
        L = pm.cfg.num_layers
        fsdp = sum(1 for x in tree_leaves(pp["layers"]) if x.dim() == 3)
        # ZeRO-3: each layer's data-sharded matrices gathered once and their
        # gradients reduce-scattered once (plus the table and the head); the
        # forward's only all-reduces are the tensor-parallel exits (two a
        # layer, one for the vocab-parallel embedding) and the loss's
        # (log-sum-exp max and sum, label logit, the mean): no product of a
        # data-sharded weight ever reduces a Partial
        assert fsdp == 7
        assert out["counts"]["all-gather"] == fsdp * L + 2
        assert out["counts"]["reduce-scatter"] == fsdp * L + 2
        assert out["fwd_counts"] == {"all-gather": fsdp * L + 2,
                                     "all-reduce": 2 * L + 1 + 4}


# ----------------------------------------------- cross_pod_sync on a mesh
def _draw(shape, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    return np.asarray(scale * rng.standard_normal(shape), np.float32)


def test_cross_pod_sync_over_the_mesh_pod_axis(tmp_path):
    """On (2, 1, 2) each rank gets the mean of its pod group's dequantized
    compressions, as the two-rank group route gives it
    (``test_torch_compression.py``), and keeps its own residual; a mesh
    without a "pod" axis returns its inputs."""
    grads = [torch.from_numpy(_draw((5, 300), 10 + pod)) for pod in range(2)]
    errs = [torch.from_numpy(_draw((5, 300), 20 + pod, 0.03)) for pod in range(2)]
    torch.save({"grads": grads, "errs": errs}, tmp_path / "payload.pt")
    _world(tmp_path, "pods")
    deq, resid = [], []
    for pod in range(2):
        g = torch.from_numpy(_draw((5, 300), 10 + pod))
        e = torch.from_numpy(_draw((5, 300), 20 + pod, 0.03))
        (q, s), ne = port_comp.compress_residual(g, e)
        deq.append(port_comp.dequantize_int8(q, s, tuple(g.shape), g.numel()))
        resid.append(ne)
    for rank in range(4):
        res = torch.load(tmp_path / f"rank{rank}.pt")
        pod = rank // 2
        assert torch.equal(res["mean"]["w"], (deq[0] + deq[1]) / 2)
        assert torch.equal(res["err"]["w"], resid[pod])
        assert torch.equal(res["same"]["w"], torch.from_numpy(_draw((5, 300), 10 + pod)))
        assert torch.equal(res["same_err"]["w"],
                           torch.from_numpy(_draw((5, 300), 20 + pod, 0.03)))
