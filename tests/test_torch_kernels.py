"""Flash-attention forward of the port (plain version, on the CPU) against
the reference's Pallas kernel in interpret mode and its jnp oracle.

Tolerances are the reference's own (tests/test_kernels.py): fp32 2e-5 — the
two sides sum in different orders —, bf16 2e-2 — one bf16 rounding of the
output."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import rel_err, to_jax, to_np, to_torch
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro_torch.kernels import flash_attention as port_fa
from repro_torch.kernels import ops as port_ops
from repro_torch.kernels import ref as port_ref

SHAPES = [
    (1, 128, 2, 64, 128, 128),
    (2, 256, 4, 64, 128, 128),
    (1, 256, 1, 128, 64, 128),
    (2, 512, 2, 32, 128, 256),
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _fold_np(t):
    B, S, H, hd = t.shape
    return t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,hd,bq,bk", SHAPES)
def test_flash_attention_matches_reference(B, S, H, hd, bq, bk, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv((B, S, H, hd))
    got = port_ops.flash_attention(*(to_torch(t, tdt) for t in (q, k, v)),
                                   causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == tdt
    jq, jk, jv = (to_jax(t, jdt) for t in (q, k, v))
    want_kernel = ref_ops.flash_attention(jq, jk, jv, causal=causal,
                                          block_q=bq, block_k=bk)
    assert rel_err(to_np(got), to_np(want_kernel)) < tol
    fold = lambda t: t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    want_ref = ref_ref.attention_ref(fold(jq), fold(jk), fold(jv), causal=causal)
    want_ref = want_ref.reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    assert rel_err(to_np(got), to_np(want_ref)) < tol


@pytest.mark.parametrize("causal", [True, False])
def test_port_oracle_matches_reference_oracle(causal):
    q, k, v = (_fold_np(t) for t in _qkv((2, 96, 2, 32), seed=3))
    got = port_ref.attention_ref(*(to_torch(t) for t in (q, k, v)), causal=causal)
    want = ref_ref.attention_ref(*(to_jax(t) for t in (q, k, v)), causal=causal)
    assert rel_err(to_np(got), to_np(want)) < 2e-5
    x = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    w = np.random.default_rng(5).standard_normal((16, 4)).astype(np.float32)
    assert rel_err(to_np(port_ref.matmul_ref(to_torch(x), to_torch(w))),
                   to_np(ref_ref.matmul_ref(to_jax(x), to_jax(w)))) < 1e-5


@pytest.mark.parametrize("Sq,Sk,causal", [(300, 300, True), (1, 1, True),
                                          (77, 77, False), (40, 200, False),
                                          (130, 257, True)])
def test_plain_version_handles_any_length(Sq, Sk, causal):
    """The reference asserts S % block == 0 (a tiling artefact); the port
    takes any length. Checked against the port's own naive oracle."""
    rng = np.random.default_rng(Sq + Sk)
    q = to_torch(rng.standard_normal((3, Sq, 16)).astype(np.float32))
    k = to_torch(rng.standard_normal((3, Sk, 16)).astype(np.float32))
    v = to_torch(rng.standard_normal((3, Sk, 16)).astype(np.float32))
    got = port_fa.flash_attention_fwd(q, k, v, causal=causal)
    want = port_ref.attention_ref(q, k, v, causal=causal)
    assert rel_err(to_np(got), to_np(want)) < 2e-5
    got_s = port_fa.flash_attention_fwd(q, k, v, causal=causal, scale=0.3)
    want_s = port_ref.attention_ref(q, k, v, causal=causal, scale=0.3)
    assert rel_err(to_np(got_s), to_np(want_s)) < 2e-5


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    q, k, v = (to_torch(_fold_np(t)) for t in _qkv((1, 32, 2, 16)))
    before = port_fa.flash_attention_fwd.launches
    a = port_fa.flash_attention_fwd(q, k, v)
    b = port_fa.flash_attention_fwd_plain(q, k, v)
    assert torch.equal(a, b)
    assert port_fa.flash_attention_fwd.launches == before


@pytest.mark.parametrize("case", ["rank", "shape", "dtype", "empty"])
def test_wrapper_rejects_bad_input(case):
    q = torch.zeros(2, 8, 16)
    if case == "rank":
        with pytest.raises(ValueError):
            port_fa.flash_attention_fwd(q[0], q[0], q[0])
    elif case == "shape":
        with pytest.raises(ValueError):
            port_fa.flash_attention_fwd(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    elif case == "dtype":
        with pytest.raises(TypeError):
            port_fa.flash_attention_fwd(q, q.bfloat16(), q)
    else:
        with pytest.raises(ValueError):
            port_fa.flash_attention_fwd(q[:, :0], q, q)


def test_kernel_sources_and_build_key():
    """The build step lists the CUDA sources in the repo and keys the
    library name by their content; nothing is built on import."""
    from repro_torch.kernels import _build
    names = [p.name for p in _build.sources()]
    assert "flash_attention_fwd.cu" in names
    t = _build._target(_build.sources()[0])
    assert t.parent == _build.build_dir() and t.suffix == ".so"
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert not _build._libs



# ---------------------------------------------------------------------------
# head dim 96 (phi3-mini-3.8b): the kernels take it natively
# ---------------------------------------------------------------------------
HD96 = [(1, 128, 3, 64, 64), (2, 256, 2, 128, 128)]   # (B, S, H, bq, bk)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,S,H,bq,bk", HD96)
def test_flash_forward_at_head_dim_96_matches_reference(B, S, H, bq, bk,
                                                        causal, dtype):
    """The port's forward at phi3-mini's head dim against the reference's
    Pallas kernel in interpret mode (its blocks span the whole head dim)."""
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv((B, S, H, 96), seed=96)
    got = port_ops.flash_attention(*(to_torch(t, tdt) for t in (q, k, v)),
                                   causal=causal)
    want = ref_ops.flash_attention(*(to_jax(t, jdt) for t in (q, k, v)),
                                   causal=causal, block_q=bq, block_k=bk)
    assert got.shape == (B, S, H, 96)
    assert rel_err(to_np(got), to_np(want)) < tol


@pytest.mark.parametrize("causal,bq,bk", [(True, 64, 64), (True, 128, 64),
                                          (False, 64, 128)])
def test_flash_stats_and_backward_at_head_dim_96_match_reference(causal, bq, bk):
    """Forward with lse (2e-5) and dq, dk, dv (1e-4) at head dim 96 against
    the reference's three pallas_calls in interpret mode, fp32."""
    from repro.kernels import flash_attention as ref_fa
    rng = np.random.default_rng(96)
    q, k, v, do = (rng.standard_normal((4, 256, 96)).astype(np.float32)
                   for _ in range(4))
    jq, jk, jv, jdo = map(to_jax, (q, k, v, do))
    r_out, r_lse = ref_fa.flash_attention_fwd_stats(
        jq, jk, jv, causal=causal, block_q=bq, block_k=bk, interpret=True)
    r_dq, r_dk, r_dv = ref_fa.flash_attention_bwd(
        jq, jk, jv, r_out, r_lse, jdo, causal=causal, block_q=bq, block_k=bk,
        interpret=True)
    tq, tk, tv, tdo = map(to_torch, (q, k, v, do))
    out, lse = port_fa.flash_attention_fwd_stats(tq, tk, tv, causal=causal)
    dq, dk, dv = port_fa.flash_attention_bwd(tq, tk, tv, out, lse, tdo,
                                             causal=causal)
    assert rel_err(to_np(out), to_np(r_out)) < 2e-5
    assert rel_err(to_np(lse), to_np(r_lse)) < 2e-5
    for name, a, b in (("dq", dq, r_dq), ("dk", dk, r_dk), ("dv", dv, r_dv)):
        assert rel_err(to_np(a), to_np(b)) < 1e-4, name


def test_head_dim_96_is_a_kernel_head_dim():
    """96 is taken by the kernels themselves; a head dim no kernel is built
    for still raises before any launch."""
    assert 96 in port_fa.HEAD_DIMS
    port_fa._check_launch((), 96, torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        port_fa._check_launch((), 80, torch.bfloat16)


# (Sq, Sk, q_offset): a sequence-parallel rank's block of queries at its
# offset over the whole sequence's keys (Sk = Sq x ranks, the last rank's
# block bottom-right aligned), offsets past a 128-key block edge and inside
# one, and queries that run past the last key
OFFSETS = [(64, 256, 0), (64, 256, 192), (100, 300, 130), (70, 300, 129),
           (128, 128, 37), (96, 512, 288)]


@pytest.mark.parametrize("Sq,Sk,q_offset", OFFSETS)
def test_flash_with_query_offset_matches_reference(Sq, Sk, q_offset):
    """B1 (``flash_attention_fwd``), B3 (its ``lse`` form) and B4 (dk/dv,
    dq), plain versions, causal with ``q_offset`` (row ``i`` sees keys
    ``0..i + q_offset``) against the reference's ``flash_attention(...,
    causal=True, q_offset=...)`` (its chunked scan) and ``jax.vjp`` through
    it, fp32: 2e-5 forward, 1e-4 backward."""
    import jax
    from repro.models import attention as ref_attn
    rng = np.random.default_rng(Sq + Sk + q_offset)
    B, H, hd = 2, 2, 32
    q, do = (rng.standard_normal((B, Sq, H, hd)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, H, hd)).astype(np.float32)
            for _ in range(2))
    fwd = lambda q, k, v: ref_attn.flash_attention(
        q, k, v, causal=True, q_offset=q_offset, chunk=64)
    want, vjp = jax.vjp(fwd, *map(to_jax, (q, k, v)))
    wdq, wdk, wdv = vjp(to_jax(do))
    tq, tk, tv, tdo = (to_torch(_fold_np(t)) for t in (q, k, v, do))
    out = port_fa.flash_attention_fwd(tq, tk, tv, q_offset=q_offset)
    out_s, lse = port_fa.flash_attention_fwd_stats(tq, tk, tv,
                                                   q_offset=q_offset)
    dq, dk, dv = port_fa.flash_attention_bwd(tq, tk, tv, out_s, lse, tdo,
                                             q_offset=q_offset)
    unfold = lambda t, S: to_np(t).reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    assert torch.equal(out, out_s)
    assert rel_err(unfold(out, Sq), to_np(want)) < 2e-5
    for name, got, w, S in (("dq", dq, wdq, Sq), ("dk", dk, wdk, Sk),
                            ("dv", dv, wdv, Sk)):
        assert rel_err(unfold(got, S), to_np(w)) < 1e-4, name
    # the layout the models call: (B, S, H, hd) through ops
    got = port_ops.flash_attention(*map(to_torch, (q, k, v)),
                                   q_offset=q_offset)
    assert rel_err(to_np(got), to_np(want)) < 2e-5


def test_zero_query_offset_is_the_plain_causal_mask():
    """``q_offset=0`` gives the plain versions' causal results bit for bit,
    and a negative offset raises."""
    q, k, v = (to_torch(_fold_np(t)) for t in _qkv((2, 200, 2, 32), seed=5))
    do = torch.randn_like(q)
    out, lse = port_fa.flash_attention_fwd_stats(q, k, v)
    out0, lse0 = port_fa.flash_attention_fwd_stats(q, k, v, q_offset=0)
    assert torch.equal(out, out0) and torch.equal(lse, lse0)
    for a, b in zip(port_fa.flash_attention_bwd(q, k, v, out, lse, do),
                    port_fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                q_offset=0)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="q_offset"):
        port_fa.flash_attention_fwd(q, k, v, q_offset=-1)
