"""Serving on a mesh: the port's ``SliceRuntime(mesh=...)`` on spawned gloo
ranks against the port's one-device runtime and the reference's mesh
runtime.

One world of 4 ranks (``test_torch_mesh.py``'s worker) runs every case, each
on its own mesh: one reduced tenant (fp32, ``slots=2``, ``max_seq=48``)
serving 3 requests of 5, 8 and 11 prompt tokens with 6 new tokens each.

* ``llama3_1x4``: 4 heads and 2 KV heads on (1, 4), so the cache splits its
  sequence over "model" and each row's new K/V is written on the rank whose
  part holds that row's position.
* ``llama3_2x2``: the cache split by KV heads, the slots over "data" (the
  paste's slot owner, each rank's rows of the per-row positions).
* ``gpt2_2x2``: fsdp_only.
* ``starcoder2_1x4``: sequence-parallel attention (3 heads, 1 KV head), with
  prompts that 4 does not divide.
* ``granite_moe_1x4``: one expert a rank.
* ``zamba2_1x4``: two SSM heads a rank, and the hybrid's shared block.
* ``llama3_2x2_spill`` / ``llama3_1x4_spill``: a budget one byte under
  what spilling the table and the KV pool frees (the card's ``runtime``
  phase's rule), so the plan puts ``params/layers/w_gate`` in the host tier
  with the table and the whole pool.
* ``llama3_2x2_split`` / ``llama3_1x4_split``: a budget that spills half of
  ``kv/k``: split into a hot prefix and a cold tail where the cache keeps
  the sequence whole (2, 2), rounded to one tier where it splits it (1, 4),
  as the reference's ``_spec_allows_seq_split`` rules.

The planner spills the table and the KV pool before any parameter (their
host traffic per byte is lower), so no budget puts a parameter in the host
tier while it splits a KV leaf: the spill and the split are separate cases.

Every case's tokens equal the one-device runtime's on the same seed, and so
do its report and its pool's global bytes and split leaves (but for the
split rounded on (1, 4)). In one subprocess with 4 host devices, the
reference's ``SliceRuntime(mesh=...)`` (inside ``with mesh:``) serves
``llama3_1x4`` and ``zamba2_1x4`` on its own weights, which the port's mesh
runtime is then given (``*_ref``); the tokens are equal. The reference's
``KVPool`` on the mesh places the four spill and split cases' pools as the
port's does (split leaves, device and host bytes).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from port_parity import ENV, np_tree
from repro.configs.base import ModelConfig as RefModelConfig
from repro.models.model_zoo import build_model as ref_build_model
from repro.serving.kv_pool import (
    _spec_allows_seq_split as ref_spec_allows_seq_split)
from repro_torch.configs import get_config
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import DEFERRED
from repro_torch.serving import Request, SliceRuntime, TenantSpec
from repro_torch.serving.kv_pool import _spec_allows_seq_split
from test_torch_mesh import (GRANITE_MOE, SRC, STARCODER2, WORLD_TIMEOUT_S,
                             _world)

SLOTS, MAX_SEQ = 2, 48
PROMPTS, NEW = (5, 8, 11), 6
PROFILE = "1s.16c"
SPILL_GRANULE = 4096
# name -> (arch, mesh shape, config overrides, budget: None (the slice's),
# "spill" (table, KV pool and w_gate to the host tier) or "split" (half of
# kv/k))
CASES = {"llama3_1x4": ("llama3-8b", (1, 4), {}, None),
         "llama3_2x2": ("llama3-8b", (2, 2), {}, None),
         "gpt2_2x2": ("gpt2-124m", (2, 2), {}, None),
         "starcoder2_1x4": ("starcoder2-7b", (1, 4), STARCODER2, None),
         "granite_moe_1x4": ("granite-moe-1b-a400m", (1, 4), GRANITE_MOE, None),
         "zamba2_1x4": ("zamba2-1.2b", (1, 4), {}, None),
         "llama3_2x2_spill": ("llama3-8b", (2, 2), {}, "spill"),
         "llama3_1x4_spill": ("llama3-8b", (1, 4), {}, "spill"),
         "llama3_2x2_split": ("llama3-8b", (2, 2), {}, "split"),
         "llama3_1x4_split": ("llama3-8b", (1, 4), {}, "split")}
# the cases the reference's mesh runtime serves on its own weights
REF_TOKENS = ("llama3_1x4", "zamba2_1x4")
# the cases whose pool the reference's KVPool places on the mesh
REF_POOLS = ("llama3_2x2_spill", "llama3_1x4_spill", "llama3_2x2_split",
             "llama3_1x4_split")
# the cases whose pool splits the KV heads over "model" (dim 3); every other
# case's splits the sequence (dim 2); the slots over "data" (dim 1)
KV_HEADS_SPLIT = ("llama3_2x2", "llama3_2x2_spill", "llama3_2x2_split")


def _cfg(arch, over):
    return get_config(arch).reduced().with_(remat="none", dtype="float32",
                                            **over)


def _requests():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 256, size=n).astype(np.int32), NEW)
            for n in PROMPTS]


def _spec(name, cfg, budget):
    """The TenantSpec fields of a case: the spill and split budgets from the
    tenant's global inventory."""
    spec = {"profile": PROFILE, "slots": SLOTS, "max_seq": MAX_SEQ}
    if budget is None:
        return spec
    model = build_model(cfg, "cpu")
    inv = model.serving_inventory(model.init(abstract=True)[0],
                                  model.cache_shapes(SLOTS, MAX_SEQ))
    size = {t.name: t.bytes for t in inv}
    free = sum(size.values()) - size["params/tok_embed"]
    if budget == "spill":
        hbm = free - size["kv/k"] - size["kv/v"] - 1
    else:
        hbm = free - size["kv/k"] // 2
    return {**spec, "hbm_budget": hbm, "spill_granule": SPILL_GRANULE}


def _one_device(name, cfg, spec):
    """The port's one-device runtime on the CPU: (outputs, report, pool)."""
    rt = SliceRuntime(device="cpu")
    t = rt.add_tenant(TenantSpec(name, cfg, **spec))
    rt.submit(name, [Request(i, p, n) for i, (p, n) in enumerate(_requests())])
    return t.engine.outputs, rt.run()["tenants"][name], t.engine.pool


_REFERENCE = textwrap.dedent("""\
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    from repro.configs.base import ModelConfig
    from repro.launch.mesh import make_host_mesh
    from repro.serving import Request, SliceRuntime, TenantSpec
    job = json.load(open(sys.argv[1]))
    out = {}
    for name, c in job.items():
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in c["cfg"].items()})
        mesh = make_host_mesh(*c["mesh"])
        with mesh:
            rt = SliceRuntime(mesh=mesh)
            t = rt.add_tenant(TenantSpec(name, cfg, **c["spec"]))
            pool = t.engine.pool
            out[name] = {"split": pool.split_leaves,
                         "bytes": [pool.device_bytes, pool.host_bytes]}
            if c["serve"]:
                rt.submit(name, [Request(i, np.asarray(p, np.int32), n)
                                 for i, (p, n) in enumerate(c["requests"])])
                rt.run()
                out[name]["outputs"] = {str(k): v for k, v in
                                        t.engine.outputs.items()}
    json.dump(out, open(sys.argv[2], "w"))
    """)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Starts the reference's subprocess, runs every case on the gloo world
    meanwhile, and the one-device runtime in this process; per case (mesh
    results, one-device outputs, report and pool), and the reference's."""
    tmp = tmp_path_factory.mktemp("mesh_runtime")
    requests = [(p.tolist(), n) for p, n in _requests()]
    cases, payload, local, job = {}, {}, {}, {}
    for name, (arch, mesh_shape, over, budget) in CASES.items():
        cfg = _cfg(arch, over)
        spec = _spec(name, cfg, budget)
        cases[name] = (arch, mesh_shape, over, spec)
        payload[name] = {"requests": requests}
        if name in REF_TOKENS + REF_POOLS:
            job[name] = {"cfg": dataclasses.asdict(cfg), "mesh": mesh_shape,
                         "spec": spec, "serve": name in REF_TOKENS,
                         "requests": requests}
        if name in REF_TOKENS:
            # the reference's weights for the tenant's seed, on the mesh
            rcfg = RefModelConfig(**dataclasses.asdict(cfg))
            rparams, _ = ref_build_model(rcfg, ENV).init(
                jax.random.PRNGKey(0))
            cases[name + "_ref"] = cases[name]
            payload[name + "_ref"] = {
                "requests": requests,
                "params": params_from_numpy(np_tree(rparams), device="cpu",
                                            dtype=cfg.param_dtype)}
    with open(tmp / "job.json", "w") as f:
        json.dump(job, f)
    (tmp / "reference.py").write_text(_REFERENCE)
    ref = subprocess.Popen(
        [sys.executable, str(tmp / "reference.py"), str(tmp / "job.json"),
         str(tmp / "reference.json")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": SRC, "JAX_PLATFORMS": "cpu"})
    try:
        torch.save(payload, tmp / "payload.pt")
        seconds = _world(tmp, "runtime", cases)
        got = torch.load(tmp / "out.pt", weights_only=False)
        got["ranks"] = [torch.load(tmp / f"outputs{r}.pt") for r in range(4)]
        got["world_s"] = round(seconds, 1)
        for name, (arch, _, over, spec) in cases.items():
            if not name.endswith("_ref"):
                local[name] = _one_device(name, _cfg(arch, over), spec)
        t0 = time.time()
        _, err = ref.communicate(timeout=WORLD_TIMEOUT_S)
        got["reference_wait_s"] = round(time.time() - t0, 1)
    finally:
        ref.kill()
    assert ref.returncode == 0, err[-3000:]
    with open(tmp / "reference.json") as f:
        reference = json.load(f)
    return got, local, reference


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_runtime_tokens_equal_one_device(case, served, request):
    got, local, _ = served
    request.node.user_properties.append(("world_s", got["world_s"]))
    outputs, report, _ = local[case]
    assert sorted(outputs) == [0, 1, 2]
    assert all(len(v) == NEW for v in outputs.values())
    assert got[case]["outputs"] == outputs
    # every rank took the same tokens from the logits gathered whole
    assert all(r[case] == outputs for r in got["ranks"])
    # the pool's bytes are held by test_mesh_pool_placed_as_planned
    skip = ("tok_per_s", "kv_device_bytes", "kv_host_bytes")
    mesh_report = dict(got[case]["report"])
    assert mesh_report["tok_per_s"] > 0
    assert ({k: v for k, v in mesh_report.items() if k not in skip}
            == {k: v for k, v in report.items() if k not in skip})


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_pool_placed_as_planned(case, served):
    """The pool's global bytes and split leaves: the one-device pool's,
    except where the mesh splits the sequence of a partly spilled leaf
    (rounded to the tier most of it was planned for); the placements are
    the cache specs'; each rank holds a quarter of the global pool."""
    got, local, _ = served
    arch, mesh_shape, _, budget = CASES[case]
    pool = local[case][2]
    mesh = got[case]
    assert mesh["pool_placements"]["k"] == [
        "S(1)", "S(3)" if case in KV_HEADS_SPLIT else "S(2)"]
    assert (mesh["report"]["kv_device_bytes"],
            mesh["report"]["kv_host_bytes"]) == tuple(mesh["bytes"])
    total = pool.device_bytes + pool.host_bytes
    assert sum(mesh["bytes"]) == total
    if arch != "zamba2-1.2b":      # its conv window is whole on every rank
        assert 4 * sum(mesh["local_bytes"]) == total
    if budget == "split" and mesh_shape == (1, 4):
        assert pool.split_leaves == {"k": MAX_SEQ // 2}
        assert mesh["split"] == {}
        # half of kv/k spilled, rounded to the host tier: v on the device,
        # k on the host
        assert tuple(mesh["bytes"]) == (pool.device_bytes - pool.host_bytes,
                                        2 * pool.host_bytes)
        return
    assert mesh["split"] == pool.split_leaves
    assert tuple(mesh["bytes"]) == (pool.device_bytes, pool.host_bytes)
    if budget == "spill":
        assert pool.host_bytes == total and "params/layers/w_gate" in \
            mesh["report"]["plan_offloaded"]
    if budget == "split":
        assert mesh["split"] == {"k": MAX_SEQ // 2}


@pytest.mark.parametrize("case", ["llama3_2x2_spill", "llama3_1x4_spill"])
def test_host_tier_shards_gathered_on_the_device_or_kept(case, served):
    """The worker takes the plan's host-tier parameters (the table and
    ``layers/w_gate``) for host-tier shards: on (2, 2) their shards are
    gathered over "data", so each is copied to the device first; on (1, 4)
    nothing is gathered, and the local shard goes to the product as it is
    (``weight_matmul`` streams it on the card). The tokens above are the
    one-device runtime's either way."""
    got, _, _ = served
    assert got[case]["place_tree_kept"]
    assert got[case]["host_params"] == 2
    gathered = got[case]["gathered_host_bytes"]
    assert (gathered > 0) if case == "llama3_2x2_spill" else gathered == 0


@pytest.mark.parametrize("case", REF_TOKENS)
def test_mesh_runtime_tokens_equal_reference_mesh_runtime(case, served):
    got, _, reference = served
    want = {int(k): v for k, v in reference[case]["outputs"].items()}
    assert got[case + "_ref"]["outputs"] == want


@pytest.mark.parametrize("case", REF_POOLS)
def test_mesh_pool_equals_reference_pool(case, served):
    got, _, reference = served
    assert got[case]["split"] == reference[case]["split"]
    assert list(got[case]["bytes"]) == reference[case]["bytes"]


def test_unserved_families_raise_naming_their_items(served):
    got, _, _ = served
    assert "A33" in got["whisper-large-v3"]
    assert "A34" in got["qwen2-vl-72b"]
    assert "serving" not in DEFERRED
    assert "A33" in DEFERRED["encdec_serving"]


@pytest.mark.parametrize("sizes", [(1, 4), (2, 2), (4, 1), (1, 1)])
@pytest.mark.parametrize("spec", [(None, "data", "model", None, None),
                                  (None, "data", None, "model", None),
                                  (None, None, ("data", "model"), None, None),
                                  (None, ("data",), "data", None, None),
                                  (None, "data"), ()])
def test_spec_allows_seq_split_equals_reference(spec, sizes):
    from jax.sharding import PartitionSpec as P
    from repro_torch.models.common import AxisEnv, pspec
    env = AxisEnv(("data", "model"), dict(zip(("data", "model"), sizes)))
    mesh = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.zeros(sizes))
    assert _spec_allows_seq_split(pspec(*spec), env) == \
        ref_spec_allows_seq_split(P(*spec), mesh)
    assert _spec_allows_seq_split(pspec(*spec), None) == \
        ref_spec_allows_seq_split(P(*spec), None)
