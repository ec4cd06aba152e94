"""The dry run on the reference's production meshes
(``repro_torch.launch.dryrun --mesh pod|multi|both``): one device's shard of
the step, run as rank 0 of a fake world of 256 or 512 ranks, at the reduced
size on the CPU.

* ``gpt2-124m train_4k --mesh multi`` (the cell of the reference's
  ``tests/test_sharding.py``) exits 0 with a record both packages'
  ``load_anchors`` read: ``n_devices`` 512, ``mesh`` "2x16x16", collective
  bytes above 0.
* A cell whose policy needs a part the mesh does not run yet is an error
  record naming its ROADMAP item; the cells of the items ported since
  (sequence-parallel attention, A25; expert-parallel MoE, A26; the VLM and
  enc-dec on a mesh, A28) are measured records of the last model rank
  (``--rank 15``).
* A sequence-parallel rank's attention grows with its offset: the counted
  FLOPs of a reduced starcoder2 training step on (2, 2) differ between model
  ranks 0 and 1 by what ``attended_pairs`` gives their query blocks.
* Expert parallelism: model ranks 0 and 1 of a reduced granite-moe step on
  (2, 2) each count the expert products of their 2 of 4 experts, half the
  unsharded step's at the same local batch.
* The port's per-device product FLOPs of a reduced llama3 train step on
  (2, 2, 2) against the reference's ``analyze_hlo`` on the same 8-device
  mesh, within the 2e-3 ``tests/test_torch_step_analysis.py`` holds one
  device to.

Every fake world runs in a subprocess, so no process group outlives its
test; the reference's ``repro.launch.dryrun`` is never imported (its first
lines set ``XLA_FLAGS`` for 512 host devices)."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.core import perfmodel as ref_pm
from repro_torch.core import perfmodel as port_pm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "JAX_PLATFORMS": "cpu"}


def _dryrun(tmp_path, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--reduced",
         "--device", "cpu", "--out", str(tmp_path), *args],
        capture_output=True, text=True, cwd=ROOT, env=ENV, timeout=300)


def test_gpt2_train_on_the_multi_pod_mesh(tmp_path):
    out = _dryrun(tmp_path, "--arch", "gpt2-124m", "--shape", "train_4k",
                  "--mesh", "multi", "--set", "grad_compression=true")
    assert out.returncode == 0, out.stderr[-3000:]
    assert "OK" in out.stdout
    with open(tmp_path / "multi" / "gpt2-124m__train_4k.json") as f:
        rec = json.load(f)
    assert rec["n_devices"] == rec["roofline"]["n_chips"] == 512
    assert rec["mesh"] == "2x16x16"
    assert rec["roofline"]["collective_bytes_per_chip"] > 0
    assert rec["collectives"]["bytes_by_op"]["all-gather"] > 0
    assert "not run" in rec["note"] and "loss" not in rec
    assert rec["grad_compression"].startswith("int8")
    for pm in (ref_pm, port_pm):
        anchors = pm.load_anchors(str(tmp_path), "multi")
        assert anchors[("gpt2-124m", "train_4k")].n_chips == 512


# the ROADMAP items a mesh runs now
PORTED = {"A25", "A26", "A27", "A28"}
# the cells' overrides: reduced zamba2's 4 heads do not divide the model
# axis, so its activations would split by sequence (an SSM scan across that
# split is A32); with 32 heads and KV heads and 64 SSM heads of 8 they
# split as the full-size model's do, 2 and 4 a rank
OVERRIDES = {("zamba2-1.2b", "A27"): ("d_model=256", "ssm_head_dim=8",
                                     "num_heads=32", "num_kv_heads=32")}
# an SSM record's (ssm_sharded, ssm_heads_local): mamba2 (fsdp_only) runs
# all its 8 reduced heads, zamba2 4 of its 64
SSM_LOCAL = {"mamba2-130m": (False, 8), "zamba2-1.2b": (True, 4)}


@pytest.mark.parametrize("arch,item", [("starcoder2-7b", "A25"),
                                       ("granite-moe-1b-a400m", "A26"),
                                       ("mamba2-130m", "A27"),
                                       ("zamba2-1.2b", "A27"),
                                       ("zamba2-1.2b", "A32"),
                                       ("qwen2-vl-72b", "A28"),
                                       ("whisper-large-v3", "A28")])
def test_deferred_policy_is_a_named_error_record(tmp_path, arch, item):
    """The cell of each arch whose policy needed a ROADMAP item on the pod
    mesh, as the last model rank: a part not ported is an error record
    naming its item, never a replicated run (reduced zamba2, whose 4 heads
    split its activations by sequence: A32). starcoder2 (36 heads, reduced
    4, on a model axis of 16: sequence-parallel attention, A25),
    granite-moe (A26; reduced, 4 heads and 4 experts: sequence-parallel,
    its experts whole on every rank), qwen2-vl (A28; reduced, its 4 heads
    are sequence-parallel too) and whisper (A28) are measured records whose
    policy says so, with the rank and its coordinates. The SSM families
    (A27) are measured records too: mamba2 fsdp_only with every SSM head on
    the rank, zamba2 with its heads split as at full size (``OVERRIDES``),
    4 SSM heads a rank (the scan's launches at those heads:
    ``test_ssm_ranks_scan_their_heads``)."""
    sets = [a for kv in OVERRIDES.get((arch, item), ()) for a in ("--set", kv)]
    out = _dryrun(tmp_path, "--arch", arch, "--shape", "train_4k",
                  "--mesh", "pod", "--rank", "15", *sets)
    with open(tmp_path / "pod" / f"{arch}__train_4k.json") as f:
        rec = json.load(f)
    assert rec["mesh"] == "16x16" and rec["rank"] == 15
    if item not in PORTED:
        assert out.returncode == 1
        assert f"ROADMAP {item}" in rec["error"] and "roofline" not in rec
        return
    assert out.returncode == 0, out.stderr[-3000:]
    assert "error" not in rec and rec["roofline"]["n_chips"] == 256
    assert rec["coords"] == {"data": 0, "model": 15}
    if item == "A27":
        assert rec["policy"]["profile"] == (
            "fsdp_only" if arch == "mamba2-130m" else "tp")
        assert not rec["policy"]["seq_parallel_attn"]
        assert rec["policy"]["ssm_sharded"] == SSM_LOCAL[arch][0]
        assert (rec["ssm_sharded"], rec["ssm_heads_local"]) == SSM_LOCAL[arch]
    else:
        assert rec["policy"]["seq_parallel_attn"]
    if item == "A26":
        assert not rec["policy"]["experts_sharded"]
        assert (rec["experts_sharded"], rec["experts_local"]) == (False, 4)
    assert rec["collectives"]["bytes_by_op"]["all-gather"] > 0
    assert "rank 15's shard" in rec["note"]
    for pm in (ref_pm, port_pm):
        anchors = pm.load_anchors(str(tmp_path), "pod")
        assert anchors[(arch, "train_4k")].n_chips == 256


# one model rank's count of a reduced starcoder2 training step (3 heads, so
# the sequence splits over "model") on a fake (2, 2) world at 512 tokens, two
# sequences: each rank holds one sequence's 256 tokens
_RANK = textwrap.dedent("""\
    import sys
    import torch
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.step_analysis import count_step
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    shape = ShapeSuite("train_4k", "train", 512, 2)
    cfg = cell_config("starcoder2-7b", shape, reduced=True,
                      overrides={"num_heads": 3, "num_kv_heads": 1})
    with fake_world(4, rank=int(sys.argv[1])):
        m = build_model(cfg, make_host_mesh(2, 2))
        assert m.pol.seq_parallel_attn
        p, _ = m.init(torch.Generator().manual_seed(0))
        b = m.synthetic_batch(shape, torch.Generator().manual_seed(1))
        _, cost = count_step(_accumulate_grads, m, p, b, 1)
    print("FLOPS", cost.flops, cfg.num_layers, cfg.num_heads, cfg.head_dim,
          cfg.remat)
    """)


def test_sequence_parallel_ranks_count_their_attended_pairs():
    """Model ranks 0 and 1 of a (2, 2) mesh hold tokens 0..255 and 256..511
    of their sequence; rank 1's queries attend keys 0..256 + i, rank 0's
    0..i. Every other product is the same on both, so the counted FLOPs
    differ by the attention's alone: per layer and head, ``attended_pairs``'
    difference times 4 hd for each forward (two: remat "layer" recomputes
    it), 8 hd for dk/dv and 6 hd for dq. On the CPU the count is of the
    plain versions, which multiply whole 128-key blocks; with both offsets
    multiples of 128 their surplus over the attended pairs is the same on
    both ranks, so the difference is exactly the kernels'."""
    from repro_torch.kernels import flash_attention as fa
    got = [_flops(_RANK.replace("int(sys.argv[1])", str(rank)))
           for rank in (0, 1)]
    (f0, L, H, hd, remat), (f1, *_) = got
    assert remat == "layer"
    pairs = [fa.attended_pairs(256, 512, True, off) for off in (0, 256)]
    assert pairs[1] - pairs[0] == 256 * 256
    per_pair = 4 * 2 + 8 + 6
    assert f1 - f0 == L * 1 * H * hd * (pairs[1] - pairs[0]) * per_pair


# the expert products counted in a reduced granite-moe training step (4
# heads, 2 KV heads, 4 experts) at 256 tokens: on the CPU the plain
# grouped_matmul (forward) and its einsum's backward; "-1" is the unsharded
# step on one device at the local batch of a (2, 2) rank, two sequences
_MOE_RANK = textwrap.dedent("""\
    import sys
    import torch
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.step_analysis import count_step
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    rank = int(sys.argv[1])
    shape = ShapeSuite("train_4k", "train", 256, 2 if rank < 0 else 4)
    cfg = cell_config("granite-moe-1b-a400m", shape, reduced=True,
                      overrides={"num_heads": 4, "num_kv_heads": 2})

    def expert_flops(m):
        p, _ = m.init(torch.Generator().manual_seed(0))
        b = m.synthetic_batch(shape, torch.Generator().manual_seed(1))
        _, cost = count_step(_accumulate_grads, m, p, b, 1)
        return sum(s.value for s in cost.top_flops_sites
                   if "gmm_ref" in s.op_name
                   or s.op_name == "(backward) BmmBackward0")
    if rank < 0:
        flops = expert_flops(build_model(cfg, "cpu"))
    else:
        with fake_world(4, rank=rank):
            m = build_model(cfg, make_host_mesh(2, 2))
            assert m.pol.experts_sharded and not m.pol.seq_parallel_attn
            flops = expert_flops(m)
    print("FLOPS", flops, cfg.num_experts)
    """)


def test_expert_parallel_ranks_count_their_experts():
    """Model ranks 0 and 1 of a reduced granite-moe step on (2, 2) hold
    experts 0-1 and 2-3. The routing is global, so each runs its two
    experts on the same capacity rows as the unsharded step: both count
    the same expert-product FLOPs, E_local / E = 1/2 of the unsharded
    step's at the same local batch (two sequences)."""
    (f0, E), (f1, _), (whole, _) = [
        _flops(_MOE_RANK.replace("int(sys.argv[1])", str(rank)))
        for rank in (0, 1, -1)]
    assert E == 4 and f0 > 0
    assert f0 == f1 == whole * 2 / E


# the prefill SSD's calls in a reduced training step (remat "layer") of
# mamba2 (2 layers) or zamba2 (4 layers in 2 groups; 8 SSM heads, 4 heads,
# 2 KV heads) on a fake (2, 2) world at 64 tokens, four sequences: the
# scan's inputs as ``_ssd_prefill`` sees them (B5's route on the card)
_SSM_RANK = textwrap.dedent("""\
    import json
    import torch
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.step_analysis import count_step
    from repro_torch.launch.dryrun import cell_config
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models import ssm
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    shape = ShapeSuite("train_4k", "train", 64, 4)
    cfg = cell_config(ARCH, shape, reduced=True)
    seen, prefill = [], ssm._ssd_prefill

    def watched(cfg, xh, dt, A, B_, C_, init_state):
        seen.append((tuple(xh.shape), tuple(A.shape), tuple(B_.shape)))
        return prefill(cfg, xh, dt, A, B_, C_, init_state)
    ssm._ssd_prefill = watched
    with fake_world(4, rank=RANK):
        m = build_model(cfg, make_host_mesh(2, 2))
        p, _ = m.init(torch.Generator().manual_seed(0))
        b = m.synthetic_batch(shape, torch.Generator().manual_seed(1))
        count_step(_accumulate_grads, m, p, b, 1)
    print("SEEN", json.dumps({"profile": m.pol.profile,
                              "ssm_sharded": m.pol.ssm_sharded,
                              "layers": cfg.num_layers, "heads": cfg.ssm_heads,
                              "calls": seen}))
    """)


@pytest.mark.parametrize("arch,rank", [("mamba2-130m", 0), ("zamba2-1.2b", 0),
                                       ("zamba2-1.2b", 1)])
def test_ssm_ranks_scan_their_heads(arch, rank):
    """The SSD scan of a reduced training step on a (2, 2) mesh runs as
    often as on one device (each layer's forward and its remat recompute;
    a hybrid group's layers once more for the group's recompute), and at
    the rank's shapes: mamba2 (fsdp_only) one of the four sequences a rank
    with all 8 SSM heads; zamba2 two sequences a data rank (the model axis
    splits heads, not rows) with 4 of the 8 SSM heads on model ranks 0 and
    1, its state's B and C whole (one state group shared by the heads)."""
    prog = _SSM_RANK.replace("ARCH", repr(arch)).replace("RANK", str(rank))
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads([ln for ln in out.stdout.splitlines()
                      if ln.startswith("SEEN")][-1][len("SEEN"):])
    L, nh = got["layers"], got["heads"]
    if arch == "mamba2-130m":
        assert (got["profile"], got["ssm_sharded"]) == ("fsdp_only", False)
        calls, B, nh_l = 2 * L, 1, nh
    else:
        assert (got["profile"], got["ssm_sharded"]) == ("tp", True)
        calls, B, nh_l = 3 * L, 2, nh // 2
    hp, N = 16, 16
    # x (B, S, nh_l, hp), A (nh_l,), B_ (B, S, N), every call the same
    assert got["calls"] == [[[B, 64, nh_l, hp], [nh_l], [B, 64, N]]] * calls


_CFG = ('get_config("llama3-8b").reduced().with_(num_heads=4, num_kv_heads=2, '
        'dtype="float32", attn_impl="xla", remat="layer")')
_REF = textwrap.dedent(f"""\
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax
    from repro.configs import get_config
    from repro.configs.shapes import ShapeSuite
    from repro.core.hlo_analysis import analyze_hlo
    from repro.launch.mesh import make_mesh_compat
    from repro.models.model_zoo import build_model
    mesh = make_mesh_compat((2, 2, 2), ("pod", "data", "model"))
    m = build_model({_CFG}, mesh)
    params, _ = m.abstract_params(mesh)
    batch = m.input_specs(ShapeSuite("t", "train", 64, 4), mesh)
    with mesh:
        hlo = jax.jit(jax.value_and_grad(m.loss_fn)).lower(
            params, batch).compile().as_text()
    print("FLOPS", analyze_hlo(hlo).flops)
    """)
_PORT = textwrap.dedent(f"""\
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSuite
    from repro_torch.core.step_analysis import count_step
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    from repro_torch.models.model_zoo import build_model
    from repro_torch.train.train_step import _accumulate_grads
    with fake_world(8):
        m = build_model({_CFG}, make_host_mesh(2, 2, pod=2))
        p, _ = m.init(torch.Generator().manual_seed(0))
        b = m.synthetic_batch(ShapeSuite("t", "train", 64, 4),
                              torch.Generator().manual_seed(1))
        _, cost = count_step(_accumulate_grads, m, p, b, 1)
    print("FLOPS", cost.flops, m.cfg.vocab_size)
    """)


def _flops(prog):
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, cwd=ROOT, env=ENV, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("FLOPS")][-1]
    return [x if x.isalpha() else float(x) for x in line.split()[1:]]


def test_product_flops_per_device_match_reference_on_2x2x2():
    """One device's product FLOPs of a reduced llama3 train step (4 heads, 2
    KV heads, fp32, remat "layer") on (pod 2, data 2, model 2): the port's
    count on a fake world of 8 against the reference's ``analyze_hlo`` of
    its GSPMD module on 8 host devices. The plans differ in one product:
    the reference takes the label logit by contracting the (B, S, V) logits
    with a one-hot (2 x B_local x S x V_local FLOPs on a device, 16,384
    here), the port gathers it. The port counts no more than the reference
    and at most 2e-3 less, the bound ``test_torch_step_analysis.py`` holds
    one device to; measured, the gap is exactly that product."""
    (want,) = _flops(_REF)
    got, vocab = _flops(_PORT)
    one_hot = 2 * (4 // 4) * 64 * (vocab // 2)
    assert got <= want
    assert (want - got) / want <= 2e-3, (got, want)
    assert want - got == one_hot, (got, want, one_hot)
