"""Training of the SSM, hybrid and MoE families in the port against the
reference, on the same numpy inputs and the reference's weights (CPU,
reduced configs, fp32): loss and every gradient leaf against
``jax.value_and_grad``, the remat routes against each other, the remat
nesting (how often each layer's forward runs), and the two autograd
Functions that put a kernel under a gradient (``models.ssm.ssd_autograd``,
``kernels.grouped_matmul.grouped_matmul_autograd``) with their plain
versions in the kernels' place.

Tolerances: a gradient leaf within 1e-4 of its largest value plus an
absolute 1e-6 (the reference's atol for leaves whose gradient vanishes: the
key bias of the shared attention, whose gradient is zero in exact
arithmetic); loss 1e-5; the Functions' gradients against direct autograd
through the same plain arithmetic 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from port_parity import model_pair, np_tree, rel_err, to_np, to_torch
from repro.data import pipeline as ref_pipeline
from repro_torch.configs import get_config
from repro_torch.kernels import grouped_matmul as port_gmm
from repro_torch.models import ssm as port_ssm
from repro_torch.models import transformer as port_tfm
from repro_torch.models.model_zoo import build_model
from repro_torch.train.train_step import _accumulate_grads

FAMILIES = [("mamba2-130m", {}), ("zamba2-1.2b", {}),
            ("zamba2-1.2b", {"num_layers": 5}),     # two groups and a tail
            ("granite-moe-1b-a400m", {})]
FAMILY_IDS = ["mamba2", "zamba2", "zamba2_tail", "granite_moe"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _leaf_close(got, want, rtol=1e-4, atol=1e-6):
    got, want = to_np(got), to_np(want)
    return float(np.max(np.abs(got - want))) <= rtol * float(np.max(np.abs(want))) + atol


def _batch(vocab, B, S, seed):
    arr = ref_pipeline.SyntheticSource(vocab, seed=seed).batch(0, B, S)
    return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}


# ---------------------------------------------------------------------------
# whole models: loss and gradients against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,over", FAMILIES, ids=FAMILY_IDS)
def test_loss_and_grads_match_reference(arch, over):
    """Model.loss_fn and every gradient leaf under remat "layer" (the
    reference's nesting on both sides), 97 tokens a row: a ragged fourth SSD
    chunk."""
    rm, rp, pm, pp = model_pair(arch, dtype="float32", remat="layer", **over)
    b = _batch(rm.cfg.vocab_size, 2, 96, 21)
    r_loss, r_grads = jax.value_and_grad(rm.loss_fn)(
        rp, {k: jnp.asarray(v) for k, v in b.items()})
    loss, grads = _accumulate_grads(pm, pp, {k: to_torch(v) for k, v in b.items()}, 1)
    assert abs(float(loss) - float(r_loss)) <= 1e-5 * abs(float(r_loss))
    want, got = _flat(np_tree(r_grads)), _flat(grads)
    assert sorted(got) == sorted(want)
    for name in want:
        assert _leaf_close(got[name], want[name]), name


def _count_ssd(monkeypatch):
    """Counts the prefill SSD's calls (the CPU route is ``ssd_chunked``)."""
    calls = [0]
    plain = port_ssm.ssd_chunked

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    monkeypatch.setattr(port_ssm, "ssd_chunked", counted)
    return calls


@pytest.mark.parametrize("arch,over", FAMILIES[:3], ids=FAMILY_IDS[:3])
def test_remat_routes_give_equal_loss_and_grads(arch, over, monkeypatch):
    """remat none, layer and offload: equal loss and gradients. The SSD's
    forward runs once a layer without remat; with remat "layer" twice for a
    layer wrapped alone (the forward and its recompute) and three times for
    a layer inside a hybrid group (the forward, the group's recompute, the
    layer's own recompute inside it). "offload" sends each checkpoint's
    input to the host (bf16 activations), "none" and "layer" nothing."""
    calls = _count_ssd(monkeypatch)
    results = {}
    for remat in ("none", "layer", "offload"):
        cfg = get_config(arch).reduced().with_(remat=remat, **over)
        model = build_model(cfg, "cpu")
        params, _ = model.init(torch.Generator().manual_seed(0))
        b = {k: to_torch(v) for k, v in _batch(cfg.vocab_size, 2, 64, 5).items()}
        before, calls[0] = port_tfm.offload_activation.d2h_bytes, 0
        loss, grads = _accumulate_grads(model, params, b, 1)
        results[remat] = (loss, _flat(grads), calls[0],
                          port_tfm.offload_activation.d2h_bytes - before)
    loss_l, g_l, n_layer, bytes_l = results["layer"]
    for remat in ("none", "offload"):
        loss, g, _, _ = results[remat]
        assert abs(float(loss) - float(loss_l)) <= 1e-6 * abs(float(loss_l))
        for name in g_l:
            assert rel_err(g[name], g_l[name]) <= 1e-6, (remat, name)
    L = cfg.num_layers
    grouped = (L // cfg.attn_every) * cfg.attn_every if cfg.attn_every else 0
    assert results["none"][2] == L
    assert n_layer == results["offload"][2] == 3 * grouped + 2 * (L - grouped)
    n_groups = L // cfg.attn_every if cfg.attn_every else 0
    row = b["tokens"].numel() * cfg.d_model * 2         # one bf16 layer input
    # every checkpoint of the backward's recompute saves its input once more
    assert results["offload"][3] == row * (L + n_groups + grouped)
    assert results["none"][3] == bytes_l == 0


# ---------------------------------------------------------------------------
# the autograd Functions, with the plain versions in the kernels' place
# ---------------------------------------------------------------------------
def _ssd_inputs(B, S, nh, hp, N, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(a.astype(np.float32)) for a in (
        0.5 * rng.standard_normal((B, S, nh, hp)),
        np.log1p(np.exp(rng.standard_normal((B, S, nh)))),
        -np.exp(0.3 * rng.standard_normal(nh)),
        0.3 * rng.standard_normal((B, S, N)),
        0.3 * rng.standard_normal((B, S, N)),
        0.2 * rng.standard_normal((B, nh, hp, N)))]


def _plain_fwd(x, dt, A, B_, C_, chunk, init_state):
    with torch.no_grad():
        return port_ssm.ssd_chunked(x, dt, A, B_, C_, chunk,
                                    init_state=init_state)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S", [64, 100])
def test_ssd_autograd_backward_matches_direct_autograd(S, with_state):
    """``ssd_autograd`` with ``ssd_chunked`` (under no_grad) as its forward:
    y, the final state and the gradients of x, dt, A, B_, C_ (and of
    init_state where it requires grad) equal autograd through
    ``ssd_chunked`` itself, for a loss that reads both outputs."""
    *ins, h0 = _ssd_inputs(2, S, 4, 16, 32, S)
    init = h0 if with_state else None
    rng = np.random.default_rng(1)
    wy = torch.from_numpy(rng.standard_normal((2, S, 4, 16)).astype(np.float32))
    ws = torch.from_numpy(rng.standard_normal((2, 4, 16, 32)).astype(np.float32))
    results = []
    for fn in ("direct", "function"):
        leaves = [t.clone().requires_grad_() for t in ins]
        st = init.clone().requires_grad_() if with_state else None
        if fn == "direct":
            y, s = port_ssm.ssd_chunked(*leaves, 32, init_state=st)
        else:
            y, s = port_ssm.ssd_autograd(_plain_fwd, *leaves, 32, st)
        loss = (y * wy).sum() + (s * ws).sum()
        wrt = leaves + ([st] if with_state else [])
        results.append((y, s, torch.autograd.grad(loss, wrt)))
    (y0, s0, g0), (y1, s1, g1) = results
    assert rel_err(to_np(y1), to_np(y0)) <= 1e-5
    assert rel_err(to_np(s1), to_np(s0)) <= 1e-5
    assert len(g1) == 6 if with_state else 5
    for a, b in zip(g0, g1):
        assert rel_err(b, a) <= 1e-5


def test_ssd_autograd_without_state_gradient():
    """A loss on y alone (training's): the state's gradient is never asked
    for, and an input that needs no gradient gets none."""
    x, dt, A, B_, C_, _ = _ssd_inputs(1, 64, 2, 16, 16, 3)
    x.requires_grad_()
    y, s = port_ssm.ssd_autograd(_plain_fwd, x, dt, A, B_, C_, 32)
    (gx,) = torch.autograd.grad(y.square().sum(), [x])
    xd = x.detach().clone().requires_grad_()
    yd, _ = port_ssm.ssd_chunked(xd, dt, A, B_, C_, 32)
    (want,) = torch.autograd.grad(yd.square().sum(), [xd])
    assert rel_err(gx, want) <= 1e-5
    assert not dt.requires_grad and s.requires_grad


@pytest.mark.parametrize("shared_x", [False, True])
def test_grouped_matmul_autograd_matches_einsum(shared_x):
    """``grouped_matmul_autograd`` with ``grouped_matmul_plain`` in the
    kernel's place: out, dx and dw equal autograd through the einsum, for
    per-expert x and for one x shared by every expert (the decode's stride
    0 view, whose dx sums over the experts)."""
    rng = np.random.default_rng(4)
    E, M, K, N = 4, 40, 24, 16
    x0 = torch.from_numpy(rng.standard_normal((1 if shared_x else E, M, K))
                          .astype(np.float32))
    w0 = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((E, M, N)).astype(np.float32))
    outs = []
    for fn in ("einsum", "function"):
        x = x0.clone().requires_grad_()
        w = w0.clone().requires_grad_()
        xe = x.expand(E, M, K)
        out = (torch.einsum("emk,ekn->emn", xe, w) if fn == "einsum" else
               port_gmm.grouped_matmul_autograd(port_gmm.grouped_matmul_plain,
                                                xe, w))
        outs.append((out,) + torch.autograd.grad(out, [x, w], dy))
    for a, b in zip(*outs):
        assert rel_err(to_np(b), to_np(a)) <= 1e-5


def test_ssd_chunked_gradients_stay_finite_when_a_chunk_decays_far():
    """dt * A summing past ~88 nats inside a chunk overflows exp(cum_i -
    cum_j) above the diagonal; the mask is taken before the exp, so the
    gradients stay finite and equal autograd through the token-by-token
    recurrence (``ssd_decode_step``), an independent oracle (fp32, 1e-4)."""
    x, dt, A, B_, C_, _ = _ssd_inputs(1, 64, 2, 8, 8, 9)
    dt = dt + 3.0                                # ~3 nats a token, 32 a chunk
    leaves = [t.clone().requires_grad_() for t in (x, dt, A, B_, C_)]
    y, _ = port_ssm.ssd_chunked(*leaves, 32)
    rng = np.random.default_rng(2)
    wy = torch.from_numpy(rng.standard_normal(tuple(y.shape)).astype(np.float32))
    got = torch.autograd.grad((y * wy).sum(), leaves)
    ref = [t.clone().requires_grad_() for t in (x, dt, A, B_, C_)]
    state = torch.zeros(1, 2, 8, 8)
    ys = []
    for t in range(64):
        state, yt = port_ssm.ssd_decode_step(state, ref[0][:, t], ref[1][:, t],
                                             ref[2], ref[3][:, t], ref[4][:, t])
        ys.append(yt)
    want = torch.autograd.grad((torch.stack(ys, 1) * wy).sum(), ref)
    assert rel_err(to_np(y), to_np(torch.stack(ys, 1))) <= 1e-4
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert rel_err(to_np(g), to_np(w)) <= 1e-4
