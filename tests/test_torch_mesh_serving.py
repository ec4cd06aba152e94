"""The mesh's serving paths (``Model.forward(return_cache=True,
last_token_only=True)`` and ``Model.decode`` on a ``DeviceMesh``) against
the unsharded port and the reference, on spawned gloo ranks.

Two worlds of 4 ranks run the cases (``WORLDS``), each case on its own
mesh: a prefill of ``PROMPT`` tokens (its next-token logits and its cache),
the cache pasted
into a pool of ``MAX_SEQ`` positions laid out by ``Model.cache_specs``, then
one decode step at each later position. Covered: the vocab-parallel head,
the K/V resharded into the cache's layout, the in-place write on the rank
whose part of a sequence-split cache holds ``pos``, the GQA read of whole KV
heads by local query heads, and the decode's softmax stats combined over the
model axis.

* llama3 (4 heads, 2 KV heads) on (2, 2): heads and KV heads split over
  "model", the cache split by KV heads.
* llama3 on (1, 4): the KV heads stay whole, the cache splits its sequence
  over "model": positions 4..7 live on model rank 1, 8..9 on rank 2.
* gpt2 on (2, 2) (fsdp_only): the prefill's batch on ("data", "model"), the
  decode's on "data" with the cache's sequence over "model".
* starcoder2 (3 heads, 1 KV head) on (2, 2) and (1, 4): sequence-parallel
  attention; the prefill's tokens split over "model" (one a rank on (1, 4)),
  each rank's K/V its part of the cache as they are, the next-token logits
  taken from the rank that holds the last position.
* qwen2-vl (4 heads, 2 KV heads) on (1, 4): Megatron SP; the prefill's
  embeddings split by sequence between tensor-parallel regions, three
  M-RoPE streams (a 1 x 2 image after the first token, so the rotary
  positions fall below the cache index), the decode as llama3's on (1, 4).
* granite-moe (reduced, 4 experts top-2) on (2, 2) and (1, 4) with its
  experts split over "model" (the decode's dense path on each rank's
  experts, weighed by their columns, the ranks summed), with 3 heads on
  (1, 4) (sequence-parallel prefill: each rank gathers the whole rows to
  route them), and with 3 experts on (2, 2) (every rank runs every
  expert).
* mamba2 (reduced) on (2, 2) (fsdp_only): the prefill's batch on ("data",
  "model"), its SSM cache moved to the decode's batch on "data", every
  model rank decoding its data group's rows.
* zamba2 (reduced: 8 SSM heads, 4 heads, 2 KV heads) on (1, 4): two SSM
  heads a rank, the state split by head, the conv window whole on every
  model rank (each rank's x channels gathered into it), the shared block's
  one head a rank reading whole KV heads from a cache split by sequence.

Every logit and cache entry (an SSM cache's conv window and state
included) is held within 1e-5 (relative to the largest)
of the unsharded port's on the same weights and tokens, and the unsharded
port within 1e-4 of the reference's (the fp32 bound of
``test_torch_models.py::test_prefill_decode_matches_forward``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, rel_err, to_jax, to_np, to_torch
from test_torch_mesh import GRANITE_MOE, GRANITE_MOE_SP, STARCODER2, _world
from test_torch_vlm import vlm_positions

LLAMA = {"num_heads": 4, "num_kv_heads": 2}
# name -> (arch, mesh shape, config overrides)
CASES = {"llama3_2x2": ("llama3-8b", (2, 2), LLAMA),
         "llama3_1x4": ("llama3-8b", (1, 4), LLAMA),
         "gpt2_2x2": ("gpt2-124m", (2, 2), {}),
         "starcoder2_2x2": ("starcoder2-7b", (2, 2), STARCODER2),
         "starcoder2_1x4": ("starcoder2-7b", (1, 4), STARCODER2),
         "qwen2vl_1x4": ("qwen2-vl-72b", (1, 4), {}),
         "granite_moe_2x2": ("granite-moe-1b-a400m", (2, 2), GRANITE_MOE),
         "granite_moe_1x4": ("granite-moe-1b-a400m", (1, 4), GRANITE_MOE),
         "granite_moe_1x4_sp": ("granite-moe-1b-a400m", (1, 4), GRANITE_MOE_SP),
         "granite_moe_2x2_e3": ("granite-moe-1b-a400m", (2, 2),
                                {**GRANITE_MOE, "num_experts": 3}),
         "mamba2_2x2": ("mamba2-130m", (2, 2), {}),
         "zamba2_1x4": ("zamba2-1.2b", (1, 4), {})}
B, PROMPT, MAX_SEQ, STEPS = 4, 4, 16, 6
# the pool's placements on (data, model): the batch over "data", and over
# "model" the KV heads (dim 3) where that axis divides them, else the
# sequence (dim 2)
POOL_PLACEMENTS = {"llama3_2x2": ["S(1)", "S(3)"],
                   "llama3_1x4": ["S(1)", "S(2)"],
                   "gpt2_2x2": ["S(1)", "S(2)"],
                   "starcoder2_2x2": ["S(1)", "S(2)"],
                   "starcoder2_1x4": ["S(1)", "S(2)"],
                   "qwen2vl_1x4": ["S(1)", "S(2)"],
                   "granite_moe_2x2": ["S(1)", "S(3)"],
                   "granite_moe_1x4": ["S(1)", "S(2)"],
                   "granite_moe_1x4_sp": ["S(1)", "S(2)"],
                   "granite_moe_2x2_e3": ["S(1)", "S(3)"],
                   "zamba2_1x4": ["S(1)", "S(2)"]}
# an SSM cache's placements: the batch over "data", the state's heads over
# "model" where it splits them, the conv window whole over "model"
SSM_PLACEMENTS = {"mamba2_2x2": {"conv": ["S(1)", "R"],
                                 "state": ["S(1)", "R"]},
                  "zamba2_1x4": {"conv": ["S(1)", "R"],
                                 "state": ["S(1)", "S(2)"]}}


def _inputs(cfg, seed: int):
    """Every position's inputs, (B, PROMPT + STEPS): token ids, or a VLM's
    embeddings and its (3, B, PROMPT + STEPS) M-RoPE positions (a text
    token, a 1 x 2 image, then text)."""
    rng = np.random.default_rng(seed)
    if cfg.family != "vlm":
        return {"tokens": rng.integers(0, cfg.vocab_size, size=(
            B, PROMPT + STEPS)).astype(np.int32)}
    pos = vlm_positions(1, 1, 2, 1, STEPS)
    return {"embeds": (0.02 * rng.standard_normal(
                (B, PROMPT + STEPS, cfg.d_model))).astype(np.float32),
            "positions": np.repeat(pos[:, None], B, axis=1)}


def _window(inputs, lo: int, hi: int, to):
    """Positions ``lo..hi`` of every input, converted by ``to``."""
    return {k: to(v[:, :, lo:hi] if k == "positions" else v[:, lo:hi])
            for k, v in inputs.items()}


def _port_serving(pm, pp, inputs):
    """Prefill -> pool -> decode on one device; (prefill logits (B, V),
    prefill cache, decode logits per step, final pool)."""
    logits, _, cache = pm.forward(pp, _window(inputs, 0, PROMPT, to_torch),
                                  return_cache=True, last_token_only=True)
    pool = pm.init_cache(B, MAX_SEQ, torch.float32)
    for k in pool:
        if k == "ssm":      # the conv window and state, whole
            for d, s in zip(pool[k], cache[k]):
                d.copy_(s)
        else:
            pool[k][:, :, :PROMPT] = cache[k]
    steps = []
    for pos in range(PROMPT, PROMPT + STEPS):
        out, _ = pm.decode(pp, pool, {**_window(inputs, pos, pos + 1, to_torch),
                                      "pos": torch.tensor(pos)})
        steps.append(out)
    return logits[:, 0], cache, steps, pool


def _ref_serving(rm, rp, inputs):
    """The reference's prefill logits and decode logits per step."""
    logits, _, cache = rm.forward(rp, _window(inputs, 0, PROMPT, to_jax),
                                  return_cache=True)
    pool = rm.init_cache(B, MAX_SEQ, jnp.float32)
    pool = {k: jax.tree_util.tree_map(
        lambda d, s: (s if k == "ssm" else d.at[:, :, :PROMPT].set(s)
                      ).astype(d.dtype), pool[k], cache[k]) for k in pool}
    steps = []
    for pos in range(PROMPT, PROMPT + STEPS):
        out, pool = rm.decode(rp, pool, {**_window(inputs, pos, pos + 1, to_jax),
                                         "pos": jnp.asarray(pos, jnp.int32)})
        steps.append(out)
    return logits[:, -1], steps


# the cases split over two worlds of 4 gloo ranks, each well inside the
# world's timeout: the dense families, then the MoE, SSM and hybrid ones
WORLDS = (("llama3_2x2", "llama3_1x4", "gpt2_2x2", "starcoder2_2x2",
           "starcoder2_1x4", "qwen2vl_1x4"),
          ("granite_moe_2x2", "granite_moe_1x4", "granite_moe_1x4_sp",
           "granite_moe_2x2_e3", "mamba2_2x2", "zamba2_1x4"))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Runs every case, on the world of ``WORLDS`` that holds it; per case
    (mesh results, unsharded port's, reference's)."""
    assert sorted(n for w in WORLDS for n in w) == sorted(CASES)
    out = {}
    for names in WORLDS:
        tmp = tmp_path_factory.mktemp("mesh_serving")
        payload, local = {}, {}
        for name in names:
            arch, _, over = CASES[name]
            rm, rp, pm, pp = model_pair(arch, seed=4, dtype="float32", **over)
            inputs = _inputs(pm.cfg, 5)
            payload[name] = {"params": pp, "prompt": PROMPT,
                             "max_seq": MAX_SEQ,
                             "inputs": {k: torch.from_numpy(v)
                                        for k, v in inputs.items()}}
            local[name] = (_port_serving(pm, pp, inputs),
                           _ref_serving(rm, rp, inputs))
        torch.save(payload, tmp / "payload.pt")
        seconds = _world(tmp, "serving", {n: CASES[n] for n in names})
        got = torch.load(tmp / "out.pt", weights_only=False)  # SSMCache tuples
        for rank in range(4):
            for name, window in torch.load(tmp / f"windows{rank}.pt").items():
                got[name].setdefault("windows", []).append(window)
        for n in names:
            got[n]["world_s"] = round(seconds, 1)
        out.update({n: (got[n],) + local[n] for n in names})
    return out


def _close(got, want, bound=1e-5):
    assert tuple(got.shape) == tuple(want.shape)
    assert rel_err(to_np(got), to_np(want)) < bound


def _cache_leaves(cache):
    """(name, tensor) of a cache tree: ``k``, ``v``, ``ssm.conv``,
    ``ssm.state``."""
    for k in sorted(cache):
        if k == "ssm":
            yield from ((f"ssm.{f}", getattr(cache[k], f))
                        for f in cache[k]._fields)
        else:
            yield k, cache[k]


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_prefill_and_decode_match_unsharded(case, served, request):
    mesh, (pre, cache, steps, pool), (ref_pre, ref_steps) = served[case]
    # its world's seconds go to the junit report
    request.node.user_properties.append(("world_s", mesh["world_s"]))
    _close(pre, to_torch(np.asarray(ref_pre)), 1e-4)
    for got, want in zip(steps, ref_steps):
        _close(got, to_torch(np.asarray(want)), 1e-4)
    _close(mesh["prefill"][:, 0], pre)
    for (name, got), (_, want) in zip(_cache_leaves(mesh["prefill_cache"]),
                                      _cache_leaves(cache)):
        _close(got, want)
    for (name, got), (_, want) in zip(_cache_leaves(mesh["pool"]),
                                      _cache_leaves(pool)):
        _close(got, want)
    assert len(mesh["decode"]) == STEPS
    for got, want in zip(mesh["decode"], steps):
        _close(got, want)
    if "ssm" in pool:
        assert mesh["pool_placements"]["ssm"] == SSM_PLACEMENTS[case]
        # every rank's conv windows are the whole ones of its batch rows
        rows = B // (2 if case.endswith("2x2") else 1)
        assert len(mesh["windows"]) == 4
        for data, window in mesh["windows"]:
            _close(window, pool["ssm"].conv[:, data * rows:(data + 1) * rows])
        if "k" not in pool:
            return
    # the pool is laid out as the reference's cache specs say, and every
    # decoded position was written (on (1, 4), by model ranks 1 and 2)
    assert mesh["pool_placements"]["k"] == POOL_PLACEMENTS[case]
    written = mesh["pool"]["k"][:, :, PROMPT:PROMPT + STEPS]
    assert float(written.abs().amin(dim=(0, 1, 3, 4)).min()) > 0
    assert float(mesh["pool"]["k"][:, :, PROMPT + STEPS:].abs().sum()) == 0
