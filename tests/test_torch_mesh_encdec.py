"""The encoder-decoder family on a mesh (whisper-large-v3, reduced, fp32):
prefilled, pooled and decoded as one rank's shard, and trained, on spawned
gloo ranks, against the unsharded port and the reference.

Reduced whisper has 4 heads, 2 KV heads and 32 encoder frames. The cases,
each on its own mesh of 4 ranks:

* ``whisper_1x4_sp``: ``test_torch_mesh.py``'s ``WHISPER`` (3 heads, 30
  frames split 8, 8, 8, 6): sequence-parallel attention, the prompts split
  by sequence over "model" (5 tokens: 2, 2, 1 and none).
* ``whisper_1x4_mha``: 4 KV heads, the real model's MHA layout: heads and KV
  heads split over "model", the self cache split by sequence all the same
  (the reference's ``cache_specs_encdec``), so each decode step gathers the
  new token's K/V over the heads before the write, and each rank cuts its
  KV heads out of the whole cross cache.
* ``whisper_1x4_gqa``: the heads split, the KV heads whole (one query head a
  rank, ``kv_group`` 2).
* ``whisper_2x2``: heads and KV heads split in two, the slots over "data".
* ``whisper_1x4_mha_spill``: ``whisper_1x4_mha`` under a plan that puts
  the embedding tables, the four ``kv/*`` leaves and ``decoder/w_in`` in the
  host tier (the budget one byte under what spilling the tables and the pool
  frees); on the CPU both tiers are one memory, so the worker takes the
  plan's host leaves for host-tier shards.

Serving, every case: prompts of 5, 8 and 11 tokens, each prefilled alone
(``Model.forward(return_cache=True, last_token_only=True)``) and pasted into
a ``KVPool`` of 2 slots x 48 positions on the mesh, decoded together with
one cache length a row for 6 ticks a request (the third request admitted
when the first two are done). The tokens equal the unsharded port's under
the same driver and plan; the logits and every cache entry (each prefill's
cache and the final pool, ``cross_k`` / ``cross_v`` included) are within
1e-5 (relative to the largest) of its. The unsharded port is held to the
reference at a scalar ``pos`` within 1e-4 (the reference decodes B
positions a row at B > 1: docs/port.md, "Intended differences").

Training (A31): ``whisper_1x4_mha``, ``whisper_2x2`` and ``whisper_1x4_gqa``
(its cross K/V projections whole on every rank): the loss within
5e-3 of the reference's and 1e-5 of the unsharded port's, every gradient
leaf (``cross_*`` and the encoder's included), gathered whole, within 1e-5
of the unsharded port's largest and within the reference's
``jax.value_and_grad`` as ``test_torch_encdec.py`` holds it; the gradients
keep their parameters' placements.

Two worlds of 4 ranks (``WORLDS``) run the cases; each world's seconds go
into the junit report.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, rel_err, to_jax, to_np, to_torch
from repro_torch.core.offload import plan_offload
from repro_torch.models.common import tree_leaves
from repro_torch.train.train_step import _accumulate_grads
from test_torch_mesh import WHISPER, _train_batch, _world

ARCH = "whisper-large-v3"
MHA = {"num_kv_heads": 4}
# name -> (mesh shape, config overrides, spill plan)
CASES = {"whisper_1x4_sp": ((1, 4), WHISPER, False),
         "whisper_1x4_mha": ((1, 4), MHA, False),
         "whisper_1x4_gqa": ((1, 4), {}, False),
         "whisper_2x2": ((2, 2), {}, False),
         "whisper_1x4_mha_spill": ((1, 4), MHA, True)}
# the training cases: the KV heads split (and their cross projections
# column-parallel), and whole on every rank (a replicated cross_wk / cross_wv
# inside the tensor-parallel region, its gradient a part on each model rank)
TRAIN = ("whisper_1x4_mha", "whisper_2x2", "whisper_1x4_gqa")
# the policy each case runs under: (head_sharded, kv_sharded,
# seq_parallel_attn)
POLICY = {"whisper_1x4_sp": (False, False, True),
          "whisper_1x4_mha": (True, True, False),
          "whisper_1x4_gqa": (True, False, False),
          "whisper_2x2": (True, True, False),
          "whisper_1x4_mha_spill": (True, True, False)}
SLOTS, MAX_SEQ, PROMPTS, NEW = 2, 48, (5, 8, 11), 6
TRAIN_BATCH = 4
SPILL_GRANULE = 4096
# the cases split over two worlds, each well inside the world's timeout
WORLDS = (("whisper_1x4_sp", "whisper_1x4_gqa", "whisper_1x4_mha_spill"),
          ("whisper_1x4_mha", "whisper_2x2"))

# The ranks run a script of their own (it imports the port alone);
# ``serve`` is the driver both the ranks and the unsharded port run.
_WORKER = textwrap.dedent("""\
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    def serve(model, params, prompts, new, slots, max_seq, plan=None):
        # each prompt prefilled alone and pasted into a free slot; all live
        # slots decoded together at their own cache lengths; a request done
        # after the prefill's token and ``new`` ticks' frees its slot
        from repro_torch.configs.shapes import ShapeSuite
        from repro_torch.models.common import is_dtensor, lay_local, pspec
        from repro_torch.serving.kv_pool import KVPool
        pool = KVPool(model, slots, max_seq, plan=plan, dtype=torch.float32)
        full = lambda t: t.full_tensor() if is_dtensor(t) else t

        def lay(batch, kind):
            if not model.sharded:
                return batch
            B, S = batch["tokens"].shape
            specs = model.batch_specs(ShapeSuite(kind, kind, S, B))
            spec = {k: specs[k][2] for k in batch if k in specs}
            spec["pos"] = pspec(specs["tokens"][2][0])
            return {k: lay_local(v, spec[k], model.env)
                    for k, v in batch.items()}

        queue, live, out = list(enumerate(prompts)), {}, {}
        got = {"prefill": [], "prefill_cache": [], "ticks": []}

        def admit():
            while queue and pool.free_slots:
                rid, (frames, tokens) = queue.pop(0)
                logits, _, pc = model.forward(
                    params, lay({"frames": frames, "tokens": tokens},
                                "prefill"),
                    return_cache=True, last_token_only=True)
                slot = pool.alloc_slot()
                pool.paste(slot, pc, tokens.shape[1])
                logits = full(logits)[0, -1]
                got["prefill"].append(logits)
                got["prefill_cache"].append({k: full(v) for k, v in pc.items()})
                out[rid] = [int(logits.argmax())]
                live[slot] = rid

        admit()
        while live:
            last = torch.zeros((slots, 1), dtype=torch.long)
            for slot, rid in live.items():
                last[slot, 0] = out[rid][-1]
            pos = torch.as_tensor(pool.positions.astype(np.int64))
            logits, cache = model.decode(
                params, pool.materialize(),
                lay({"tokens": last, "pos": pos}, "decode"))
            pool.update(cache)
            logits = full(logits)
            got["ticks"].append(logits)
            for slot, rid in list(live.items()):
                out[rid].append(int(logits[slot].argmax()))
                pool.positions[slot] += 1
                if len(out[rid]) > new:
                    del live[slot]
                    pool.free_slot(slot)
            admit()
        got["tokens"] = out
        cache = pool.materialize()
        got["pool"] = {k: full(v) for k, v in cache.items()}
        got["pool_placements"] = {
            k: [str(p) for p in v.placements] for k, v in cache.items()
            if is_dtensor(v)}
        return got

    def train(model, params, batch):
        from repro_torch.models.common import tree_leaves
        from repro_torch.train.train_step import _accumulate_grads
        loss, grads = _accumulate_grads(model, params, batch, 1)
        return {"loss": float(loss),
                "grads": [g.full_tensor() for g in tree_leaves(grads)],
                "same_layout": all(
                    g.placements == p.placements for g, p in
                    zip(tree_leaves(grads), tree_leaves(params)))}

    def encdec(rank, out_dir, cases):
        from repro_torch.configs import get_config
        from repro_torch.configs.shapes import ShapeSuite
        from repro_torch.core.offload import _flatten_with_paths
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models import common, layers
        from repro_torch.models.model_zoo import build_model, shard_tree
        payload = torch.load(os.path.join(out_dir, "payload.pt"),
                             weights_only=False)
        res = {}
        for name, (mesh_shape, over) in cases.items():
            p = payload[name]
            cfg = get_config("whisper-large-v3").reduced().with_(
                remat="none", dtype="float32", **over)
            model = build_model(cfg, make_host_mesh(*mesh_shape))
            pol = model.pol
            _, specs = model.init(abstract=True)
            params = shard_tree(p["params"], specs, model.env)
            got = {"policy": (pol.head_sharded, pol.kv_sharded,
                              pol.seq_parallel_attn),
                   "num_layers": (cfg.num_layers, cfg.encoder_layers)}
            plan = p.get("plan")
            own_on_host, own_matmul = common.on_host, layers.weight_matmul
            streamed = []
            if plan is not None:
                # the plan's host-tier parameters taken for host-tier shards
                # (on the CPU both tiers are one memory); each decoder
                # layer's w_in slice of the rank's shard watched into the
                # product
                host = {x.to_local().untyped_storage().data_ptr()
                        for path, x in _flatten_with_paths({"params": params})
                        if plan.is_offloaded(path)}
                w_in = params["decoder"]["w_in"].to_local()
                shard = {w_in[i].data_ptr() for i in range(cfg.num_layers)}
                common.on_host = lambda w: (
                    common.is_dtensor(w)
                    and w.to_local().untyped_storage().data_ptr() in host)

                def watched(x, w):
                    if w.shape == w_in.shape[1:]:
                        streamed.append(w.data_ptr() in shard)
                    return own_matmul(x, w)
                layers.weight_matmul = watched
                common.gather_param.h2d_bytes = 0
            try:
                got.update(serve(model, params, p["prompts"], p["new"],
                                 p["slots"], p["max_seq"], plan))
            finally:
                common.on_host, layers.weight_matmul = own_on_host, own_matmul
            if plan is not None:
                got["w_in_products"] = streamed
                got["gathered_host_bytes"] = common.gather_param.h2d_bytes
            if "train" in p:
                bspecs = {k: v[2] for k, v in model.batch_specs(ShapeSuite(
                    "t", "train", p["train"]["tokens"].shape[1],
                    p["train"]["tokens"].shape[0])).items()}
                got["train"] = train(model, params, shard_tree(
                    p["train"], bspecs, model.env))
            res[name] = got
        if rank == 0:
            torch.save(res, os.path.join(out_dir, "out.pt"))

    def rank_main(rank, out_dir, job):
        from repro_torch.launch.mesh import init_world
        init_world(rank, 4, "file://" + os.path.join(out_dir, "store"),
                   device_type="cpu", timeout_s=60)
        try:
            encdec(rank, out_dir, torch.load(os.path.join(out_dir, "job.pt")))
        finally:
            dist.destroy_process_group()

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(sys.argv[1], sys.argv[2]), nprocs=4)
    """)
_DRIVER = {}
exec(compile(_WORKER, "worker.py", "exec"), _DRIVER)     # serve, train


def _prompts(cfg):
    """Each request's frames (1, encoder_seq, d_model) and tokens (1, n)."""
    rng = np.random.default_rng(9)
    return [(torch.from_numpy((0.02 * rng.standard_normal(
                (1, cfg.encoder_seq, cfg.d_model))).astype(np.float32)),
             torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(1, n))))
            for n in PROMPTS]


def _spill_plan(pm):
    """The budget one byte under what spilling the tables and the pool
    frees: the plan also puts ``decoder/w_in`` in the host tier."""
    inv = pm.serving_inventory(pm.init(abstract=True)[0],
                               pm.cache_shapes(SLOTS, MAX_SEQ))
    budget = sum(t.bytes for t in inv) - 1 - sum(
        t.bytes for t in inv if t.group in ("embed", "kv_cache"))
    return plan_offload(inv, budget, spill_granule=SPILL_GRANULE)


def _scalar_pos(rm, rp, pm, pp):
    """Prefill of 8 tokens on 2 rows, then 6 teacher-forced decode steps at
    a scalar ``pos`` on a pool of ``MAX_SEQ``: the unsharded port's and the
    reference's logits, step by step."""
    rng = np.random.default_rng(11)
    P, B = 8, 2
    frames = (0.02 * rng.standard_normal(
        (B, pm.cfg.encoder_seq, pm.cfg.d_model))).astype(np.float32)
    tokens = rng.integers(0, pm.cfg.vocab_size, size=(B, P + NEW))
    pre = {"frames": frames, "tokens": tokens[:, :P]}
    got, _, pc = pm.forward(pp, {k: to_torch(v) for k, v in pre.items()},
                            return_cache=True, last_token_only=True)
    want, _, rc = rm.forward(rp, {k: to_jax(v) for k, v in pre.items()},
                             return_cache=True)
    steps = [(got[:, 0], want[:, -1])]
    pool = pm.init_cache(B, MAX_SEQ, torch.float32)
    rpool = rm.init_cache(B, MAX_SEQ, jnp.float32)
    for k in pool:
        if k in ("k", "v"):
            pool[k][:, :, :P] = pc[k]
            rpool[k] = rpool[k].at[:, :, :P].set(rc[k])
        else:
            pool[k].copy_(pc[k])
            rpool[k] = rc[k].astype(jnp.float32)
    for pos in range(P, P + NEW):
        nxt = tokens[:, pos:pos + 1]
        got, _ = pm.decode(pp, pool, {"tokens": to_torch(nxt),
                                      "pos": torch.tensor(pos)})
        want, rpool = rm.decode(rp, rpool, {"tokens": to_jax(nxt),
                                            "pos": jnp.asarray(pos, jnp.int32)})
        steps.append((got, want))
    return steps


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Runs every case on the world of ``WORLDS`` that holds it; per case
    (mesh results, the unsharded port's under the same driver and plan,
    its and the reference's logits at a scalar pos, the training
    references)."""
    assert sorted(n for w in WORLDS for n in w) == sorted(CASES)
    out = {}
    for names in WORLDS:
        tmp = tmp_path_factory.mktemp("mesh_encdec")
        payload, local = {}, {}
        for name in names:
            mesh_shape, over, spill = CASES[name]
            rm, rp, pm, pp = model_pair(ARCH, seed=4, dtype="float32", **over)
            prompts = _prompts(pm.cfg)
            plan = _spill_plan(pm) if spill else None
            payload[name] = {"params": pp, "prompts": prompts, "new": NEW,
                             "slots": SLOTS, "max_seq": MAX_SEQ, "plan": plan}
            ref = {"one_device": _DRIVER["serve"](pm, pp, prompts, NEW, SLOTS,
                                                  MAX_SEQ, plan),
                   "scalar_pos": _scalar_pos(rm, rp, pm, pp), "plan": plan}
            if name in TRAIN:
                batch = _train_batch(pm.cfg, TRAIN_BATCH)
                pbatch = {k: to_torch(v) for k, v in batch.items()}
                payload[name]["train"] = pbatch
                ref_loss, ref_grads = jax.value_and_grad(rm.loss_fn)(
                    rp, {k: to_jax(v) for k, v in batch.items()})
                loss, grads = _accumulate_grads(pm, pp, pbatch, 1)
                ref["train"] = (float(ref_loss),
                                [to_np(g) for g in
                                 jax.tree_util.tree_leaves(ref_grads)],
                                float(loss), list(tree_leaves(grads)))
            local[name] = ref
        torch.save(payload, tmp / "payload.pt")
        seconds = _world(tmp, "encdec", {n: CASES[n][:2] for n in names},
                         worker=_WORKER)
        got = torch.load(tmp / "out.pt", weights_only=False)
        for n in names:
            got[n]["world_s"] = round(seconds, 1)
            out[n] = (got[n], local[n])
    return out


def _close(got, want, bound=1e-5):
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(to_np(got), to_np(want)) < bound


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_serving_matches_unsharded(case, served, request):
    mesh, ref = served[case]
    request.node.user_properties.append(("world_s", mesh["world_s"]))
    assert mesh["policy"] == POLICY[case]
    one = ref["one_device"]
    assert sorted(one["tokens"]) == [0, 1, 2]
    assert all(len(t) == NEW + 1 for t in one["tokens"].values())
    assert mesh["tokens"] == one["tokens"]
    assert len(mesh["prefill"]) == len(PROMPTS)
    assert len(mesh["ticks"]) == len(one["ticks"]) == 2 * NEW
    for got, want in zip(mesh["prefill"] + mesh["ticks"],
                         one["prefill"] + one["ticks"]):
        _close(got, want)
    for got, want in zip(mesh["prefill_cache"] + [mesh["pool"]],
                         one["prefill_cache"] + [one["pool"]]):
        assert sorted(got) == ["cross_k", "cross_v", "k", "v"]
        for k in got:
            _close(got[k], want[k])
    # the pool as cache_specs_encdec lays it out: the slots over "data",
    # the self K/V's sequence over "model" whatever the heads do, the cross
    # K/V whole over it
    for k in ("k", "v"):
        assert mesh["pool_placements"][k] == ["S(1)", "S(2)"]
    for k in ("cross_k", "cross_v"):
        assert mesh["pool_placements"][k] == ["S(1)", "R"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_unsharded_port_matches_reference_at_scalar_pos(case, served):
    _, ref = served[case]
    for got, want in ref["scalar_pos"]:
        _close(got, to_torch(np.asarray(want)), 1e-4)


def test_spilled_w_in_shard_goes_to_the_product_ungathered(served):
    """Under the spill plan every decoder layer's product with ``w_in``, in
    every prefill and tick, takes the rank's host-tier shard as it is (its
    layer slice of the local tensor): nothing is copied to the device or
    gathered, on (1, 4). The encoder's ``w_in`` stays on the device."""
    mesh, ref = served["whisper_1x4_mha_spill"]
    plan = ref["plan"]
    assert set(plan.offloaded) == {
        "params/tok_embed", "params/pos_embed", "params/enc_pos_embed",
        "params/decoder/w_in", "kv/k", "kv/v", "kv/cross_k", "kv/cross_v"}
    # the products at w_in's shape: the decoder's, one a layer of every
    # prefill and tick, on the shard; the encoder's, one a layer of every
    # prefill, on its own (device-tier) weights
    L, L_enc = mesh["num_layers"]
    products = mesh["w_in_products"]
    assert sum(products) == (len(PROMPTS) + 2 * NEW) * L
    assert len(products) - sum(products) == len(PROMPTS) * L_enc
    assert mesh["gathered_host_bytes"] == 0


@pytest.mark.parametrize("case", TRAIN)
def test_head_split_loss_and_grads_match_reference(case, served, request):
    mesh, ref = served[case]
    request.node.user_properties.append(("world_s", mesh["world_s"]))
    ref_loss, ref_grads, want_loss, want = ref["train"]
    got = mesh["train"]
    assert abs(got["loss"] - ref_loss) / abs(ref_loss) < 5e-3
    assert abs(got["loss"] - want_loss) <= 1e-5 * abs(want_loss)
    assert got["same_layout"]
    assert len(got["grads"]) == len(want) == len(ref_grads)
    top = max(float(g.abs().max()) for g in want)
    for g, w, r in zip(got["grads"], want, ref_grads):
        assert g.shape == w.shape
        assert float((g - w).abs().max()) <= 1e-5 * top
        g = to_np(g)
        assert np.max(np.abs(g - r)) <= 1e-4 * np.max(np.abs(r)) + 1e-6
