"""The port's step counter (``repro_torch.core.step_analysis``) against the
reference's loop-aware HLO analyzer: its rules mirror
``tests/test_hlo_analysis.py``, its product FLOPs of a reduced forward and
train step equal ``analyze_hlo``'s within a stated tolerance, and each
kernel's ``kernel_cost`` formula is held to the products its plain version
issues."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _get_current_dispatch_mode

from port_parity import model_pair, to_torch
from repro.core.hlo_analysis import analyze_hlo
from repro_torch.core.step_analysis import StepCost, count_step
from repro_torch.kernels import _counter
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import grouped_matmul as gmm
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.kernels import stream_matmul as sm
from repro_torch.train.train_step import _accumulate_grads


def _rng(seed):
    return np.random.default_rng(seed)


def _t(*shape, seed=0, dtype=torch.float32):
    return torch.from_numpy(_rng(seed).standard_normal(shape).astype(np.float32)).to(dtype)


# ---------------------------------------------------------------- the rules
@pytest.mark.parametrize("op", ["mm", "addmm", "bmm", "baddbmm"])
def test_product_flops_exact(op):
    a, b = _t(64, 128), _t(128, 256, seed=1)
    fns = {"mm": (lambda: a @ b, 2 * 64 * 128 * 256),
           "addmm": (lambda: torch.addmm(_bias, a, b), 2 * 64 * 128 * 256),
           "bmm": (lambda: torch.bmm(a[None].expand(3, -1, -1),
                                     b[None].expand(3, -1, -1)),
                   3 * 2 * 64 * 128 * 256),
           "baddbmm": (lambda: torch.baddbmm(_bias[None].expand(3, -1, -1),
                                             a[None].expand(3, -1, -1),
                                             b[None].expand(3, -1, -1)),
                       3 * 2 * 64 * 128 * 256)}
    fn, want = fns[op]
    out, cost = count_step(fn)
    assert cost.flops == want
    assert out.shape[-2:] == (64, 256)


_bias = _t(256, seed=2)


def test_elementwise_ops_count_no_flops():
    x = _t(64, 128)
    _, cost = count_step(lambda: torch.tanh(x * 2.0 + 1.0).sum())
    assert cost.flops == 0
    assert cost.ops == 4


def test_python_loop_of_n_layers_counts_n_times():
    """The counterpart of the reference's scan trip-count test: an eager loop
    issues its body every pass, so no trip count is recovered."""
    x, w = _t(32, 64), _t(64, 64, seed=1)

    def f(x, w):
        for _ in range(7):
            x = torch.tanh(x @ w)
        return x
    _, cost = count_step(f, x, w)
    assert cost.flops == 7 * 2 * 32 * 64 * 64

    def nested(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    _, cost = count_step(nested, x, w)
    assert cost.flops == 5 * 3 * 2 * 32 * 64 * 64


def test_slicing_traffic_counts_window_not_operand():
    big = torch.zeros(1024, 256)     # 1 MiB
    _, cost = count_step(lambda b: b[:8] * 2.0, big)
    # the window read (8 x 256 fp32) and the product written: 16 KiB
    assert cost.bytes_accessed == 2 * 8 * 256 * 4
    _, cost = count_step(lambda b: torch.index_select(b, 0, torch.arange(8)), big)
    assert cost.bytes_accessed < 200_000, cost.bytes_accessed


def test_broadcast_counts_once():
    row = torch.ones(1, 256)
    wide = row.expand(1024, 256)     # stride 0 along dim 0
    _, cost = count_step(lambda a: a * 2.0, wide)
    assert cost.bytes_accessed == 256 * 4 + 1024 * 256 * 4


def test_views_and_allocations_count_zero():
    x = _t(16, 32, 8)
    _, cost = count_step(lambda: x.permute(2, 0, 1).reshape(8, 512)[:, 3]
                         .view(8, 1).expand(8, 4).t().unsqueeze(0)
                         .select(0, 0).detach())
    assert cost.bytes_accessed == 0 and cost.ops == 0 and cost.flops == 0
    _, cost = count_step(lambda: (torch.empty(1000), x.new_empty(10),
                                  torch.empty_like(x)))
    assert cost.bytes_accessed == 0 and cost.ops == 0


def test_copy_off_the_host_goes_to_host_bytes():
    """A copy between the host and a device goes to ``host_bytes``, not to
    HBM. The CPU has no card, so the device here is ``meta``; the real H2D
    copy is held on the card (``tests/test_torch_gpu.py``)."""
    x = _t(64, 128)
    _, cost = count_step(lambda: x.to("meta"))
    assert cost.host_bytes == 64 * 128 * 4
    assert cost.bytes_accessed == 0
    _, cost = count_step(lambda: x.to(torch.bfloat16))   # same device: HBM
    assert cost.host_bytes == 0
    assert cost.bytes_accessed == 64 * 128 * (4 + 2)


def test_backward_is_counted_and_sited():
    x = _t(64, 128).requires_grad_()
    w = _t(128, 256, seed=1).requires_grad_()
    _, cost = count_step(lambda: (x @ w).sum().backward())
    assert cost.flops == 3 * 2 * 64 * 128 * 256
    names = {s.op_name for s in cost.top_flops_sites}
    assert "(backward) MmBackward0" in names


def test_sites_name_the_port_source_line():
    rm, rp, pm, pp = model_pair("llama3-8b", seed=0, dtype="float32")
    toks = to_torch(_rng(3).integers(0, pm.cfg.vocab_size, (2, 16)).astype(np.int32))
    _, cost = count_step(lambda: pm.forward(pp, {"tokens": toks}))
    assert cost.top_flops_sites
    for s in cost.top_flops_sites:
        assert s.op_name.split(":")[0].endswith(".py"), s.op_name
        assert s.multiplier >= 1
    assert sum(s.value for s in cost.top_flops_sites) <= cost.flops
    assert any("weight_matmul" in s.op_name for s in cost.top_flops_sites)


def test_collectives_by_the_bytes_they_write(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1)
    try:
        x = torch.ones(1000)
        _, cost = count_step(lambda: dist.all_reduce(x))
        assert cost.collective_bytes == {"all-reduce": 4000.0}
        assert cost.collective_counts == {"all-reduce": 1}
        assert cost.total_collective_bytes == 4000.0
        assert cost.top_collective_sites[0].kind == "all-reduce"
    finally:
        dist.destroy_process_group()


def test_nested_counter_raises_and_leaves_the_outer_one():
    x = _t(8, 8)
    seen = {}

    def outer():
        y = x @ x
        with pytest.raises(RuntimeError, match="do not nest"):
            count_step(lambda: x @ x)
        seen["active"] = _counter.active is not None
        return y @ x
    _, cost = count_step(outer)
    assert seen["active"]
    assert cost.flops == 2 * 2 * 8 * 8 * 8
    assert _counter.active is None


def test_failure_inside_leaves_no_mode_active():
    def boom():
        torch.ones(3) * 2
        raise ValueError("inside the step")
    with pytest.raises(ValueError, match="inside the step"):
        count_step(boom)
    assert _counter.active is None
    assert _get_current_dispatch_mode() is None
    _, cost = count_step(lambda: torch.ones(4) @ torch.ones(4, 2))
    assert cost.flops == 2 * 4 * 2


def test_record_kernel_hook():
    """Inside ``count_step`` a reported launch adds its work to the totals
    and is counted by kernel and route, and the wrappers' own launch counts
    are not touched."""
    before = gmm.grouped_matmul.launches
    _, cost = count_step(lambda: (_counter.record_kernel(
        "grouped_matmul", "wgmma", 1e9, 1e6, 5.0), _counter.record_kernel(
        "flash_attention_fwd", "fma", 2e9, 3e6)))
    assert cost.flops == 3e9 and cost.kernel_flops == 3e9
    assert cost.bytes_accessed == 4e6 and cost.host_bytes == 5.0
    assert cost.kernel_launches == {"grouped_matmul": 1, "flash_attention_fwd": 1}
    assert cost.kernel_launches_by_route == {"grouped_matmul": {"wgmma": 1},
                                             "flash_attention_fwd": {"fma": 1}}
    assert gmm.grouped_matmul.launches == before


def test_scaled_and_added_costs():
    x = _t(16, 16)
    _, a = count_step(lambda: x @ x)
    _, b = count_step(lambda: torch.tanh(x))
    c = a.scaled(3) + b
    assert c.flops == 3 * a.flops
    assert c.bytes_accessed == 3 * a.bytes_accessed + b.bytes_accessed
    assert c.ops == 3 * a.ops + b.ops
    assert c.top_flops_sites[0].multiplier == 3
    assert isinstance(StepCost() + StepCost(), StepCost)


# ------------------------------------------------- kernel_cost vs plain products
def test_stream_matmul_kernel_cost_equals_plain_products():
    x, w = _t(48, 96), _t(96, 80, seed=1)
    _, cost = count_step(sm.stream_matmul_plain, x, w)
    flops, nbytes, host = sm.kernel_cost(x, w, on_host=False)
    assert flops == cost.flops == 2 * 48 * 96 * 80
    assert nbytes == (48 * 96 + 48 * 80 + 96 * 80) * 4 and host == 0
    assert sm.kernel_cost(x, w, on_host=True)[2] == 96 * 80 * 4


@pytest.mark.parametrize("shared", [False, True])
def test_grouped_matmul_kernel_cost_equals_plain_products(shared):
    x = (_t(1, 24, 32).expand(4, 24, 32) if shared else _t(4, 24, 32))
    w = _t(4, 32, 40, seed=1)
    _, cost = count_step(gmm.grouped_matmul_plain, x, w)
    flops, nbytes, _ = gmm.kernel_cost(x, w, on_host=False)
    assert flops == cost.flops == 2 * 4 * 24 * 32 * 40
    assert nbytes == ((1 if shared else 4) * 24 * 32 + 4 * 32 * 40
                      + 4 * 24 * 40) * 4


def _flash_inputs(BH, Sq, Sk, hd):
    q, k, v = _t(BH, Sq, hd), _t(BH, Sk, hd, seed=1), _t(BH, Sk, hd, seed=2)
    out, lse = fa.flash_attention_fwd_stats_plain(q, k, v, causal=False)
    dout = _t(BH, Sq, hd, seed=3)
    return q, k, v, dout, lse, fa.bwd_delta(out, dout)


@pytest.mark.parametrize("Sq,Sk", [(200, 200), (96, 300)])
def test_flash_kernel_cost_equals_plain_products_non_causal(Sq, Sk):
    q, k, v, dout, lse, delta = _flash_inputs(3, Sq, Sk, 16)
    plain = {
        "flash_attention_fwd": lambda: fa.flash_attention_fwd_plain(
            q, k, v, causal=False),
        "flash_attention_fwd_stats": lambda: fa.flash_attention_fwd_stats_plain(
            q, k, v, causal=False),
        "flash_attention_bwd_dkdv": lambda: fa.flash_attention_bwd_dkdv_plain(
            q, k, v, dout, lse, delta, causal=False),
        "flash_attention_bwd_dq": lambda: fa.flash_attention_bwd_dq_plain(
            q, k, v, dout, lse, delta, causal=False)}
    per_pair = {"flash_attention_fwd": 4, "flash_attention_fwd_stats": 4,
                "flash_attention_bwd_dkdv": 8, "flash_attention_bwd_dq": 6}
    for name, fn in plain.items():
        _, cost = count_step(fn)
        flops, _ = fa.kernel_cost(name, q, k, causal=False)
        assert flops == cost.flops == per_pair[name] * 3 * Sq * Sk * 16, name


def test_flash_kernel_cost_causal_relation():
    """Causal, the kernel attends ``S(S+1)/2`` pairs, about half of ``S x S``;
    the plain version multiplies every row of each kv block that reaches the
    diagonal (block 128), so it counts the kernel's products plus the rows
    above the diagonal inside those blocks."""
    BH, S, hd, blk = 2, 300, 16, 128
    q, k, v = _t(BH, S, hd), _t(BH, S, hd, seed=1), _t(BH, S, hd, seed=2)
    flops, _ = fa.kernel_cost("flash_attention_fwd", q, k, causal=True)
    assert fa.attended_pairs(S, S, True) == S * (S + 1) // 2
    assert flops == 4 * BH * hd * S * (S + 1) // 2
    _, cost = count_step(lambda: fa.flash_attention_fwd_plain(q, k, v, causal=True))
    assert cost.flops == 4 * BH * hd * S * S      # every block reaches row S-1
    assert flops < cost.flops < 2.1 * flops
    assert fa.attended_pairs(100, 300, True) == 100 * 101 // 2
    assert fa.attended_pairs(300, 100, True) == 100 * 101 // 2 + 200 * 100


@pytest.mark.parametrize("Sq,Sk,q_offset", [(256, 4096, 3840), (256, 4096, 0),
                                             (100, 300, 130), (128, 128, 37),
                                             (300, 100, 7), (5, 10, 20)])
def test_attended_pairs_with_query_offset(Sq, Sk, q_offset):
    """Row ``r`` at position ``r + q_offset`` attends ``min(r + 1 +
    q_offset, Sk)`` keys; a sequence-parallel rank's block of ``Sq`` queries
    at its offset over all ``Sk`` keys attends ``(q_offset + Sq / 2) Sq``
    pairs (plus ``Sq / 2``) while its block lies inside the keys; the kernel
    cost follows."""
    want = sum(min(r + 1 + q_offset, Sk) for r in range(Sq))
    assert fa.attended_pairs(Sq, Sk, True, q_offset) == want
    if Sq + q_offset <= Sk:
        assert want == (2 * q_offset + Sq + 1) * Sq // 2
    q, k = _t(2, Sq, 16), _t(2, Sk, 16, seed=1)
    flops, _ = fa.kernel_cost("flash_attention_bwd_dq", q, k, True, q_offset)
    assert flops == 6 * 2 * 16 * want


def test_ssd_kernel_cost_counts_the_chunk_triangle():
    x = _t(1, 130, 4, 16)
    B_ = _t(1, 130, 32, seed=1)
    flops, nbytes = ssd.kernel_cost(x, B_, with_init=False, with_state=True)
    pairs = 64 * 65 // 2 * 2 + 2 * 3 // 2       # chunks of 64, 64 and 2 rows
    assert flops == 2 * pairs * 32 + 2 * 4 * (pairs * 16 + 2 * 130 * 16 * 32)
    assert nbytes > 2 * x.numel() * 4


# ------------------------------------------------ against the reference's counts
# The port's product FLOPs of the same reduced config, fp32, attention in
# "xla" (no kernels), against analyze_hlo's dot FLOPs of the reference's jitted
# function. Measured: the forward equal (gpt2, llama3) or 3.1e-4 under
# (granite-moe); the train step 5.3e-4 to 9.5e-4 under. The reference
# contracts one-hot tensors where the port gathers: its loss takes the label
# logit by a (B, S, V) one-hot product (2 B S V FLOPs the port does not
# issue) and its MoE combine a one-hot product over the experts. Tolerance:
# the port counts no more than the reference and at most 2e-3 less.
FLOPS_TOL = 2e-3


@pytest.fixture(scope="module")
def batch_2x64():
    rng = _rng(7)
    return (rng.integers(0, 256, size=(2, 64)).astype(np.int32),
            rng.integers(0, 256, size=(2, 64)).astype(np.int32))


@pytest.mark.parametrize("arch", ["gpt2-124m", "llama3-8b", "granite-moe-1b-a400m"])
@pytest.mark.parametrize("kind", ["forward", "train"])
def test_counted_flops_match_reference_analyze_hlo(arch, kind, batch_2x64):
    rm, rp, pm, pp = model_pair(arch, seed=0, dtype="float32", attn_impl="xla",
                                remat="layer", capacity_factor=8.0)
    toks, labels = batch_2x64
    toks, labels = toks % rm.cfg.vocab_size, labels % rm.cfg.vocab_size
    if kind == "forward":
        hlo = jax.jit(lambda p, b: rm.forward(p, b, last_token_only=True)[0]) \
            .lower(rp, {"tokens": jnp.asarray(toks)}).compile().as_text()
        _, cost = count_step(lambda: pm.forward(
            pp, {"tokens": to_torch(toks)}, last_token_only=True))
    else:
        rb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
        hlo = jax.jit(jax.value_and_grad(rm.loss_fn)).lower(rp, rb) \
            .compile().as_text()
        pb = {"tokens": to_torch(toks), "labels": to_torch(labels)}
        _, cost = count_step(lambda: _accumulate_grads(pm, pp, pb, 1))
    want = analyze_hlo(hlo).flops
    assert cost.flops <= want
    assert (want - cost.flops) / want <= FLOPS_TOL, (cost.flops, want)
