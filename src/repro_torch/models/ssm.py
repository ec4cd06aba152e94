"""Mamba2 — SSD (state-space duality) layer: chunked prefill and decode.

Counterpart of ``repro/models/ssm.py``: names, shapes, casts and the chunked
algorithm are the reference's. Layout: x (B, S, nh, hp); A (nh,) negative
decay; dt (B, S, nh) softplus-ed; B_, C_ (B, S, N) with a single state group
shared across heads.

The prefill SSD goes where the reference calls ``ssd_chunked`` and takes its
route from the tensors' device, as ``weight_matmul`` does:

* CPU tensors: ``ssd_chunked`` (plain torch ops, differentiated by
  autograd as the reference differentiates its XLA-level ``ssd_chunked``);
* CUDA tensors: ``ssd_autograd`` with the hand-written ``ssd_scan`` kernel
  (``kernels.ops.ssd``) as its forward. Its backward recomputes
  ``ssd_chunked`` on the saved inputs under autograd: the reference has no
  SSD backward kernel either.

Decode is plain torch ops, as the reference's is plain XLA, and writes the
layer's conv window and state **in place** into the cache it is given.
Products with a weight go through ``weight_matmul``, so a plan-spilled
projection streams through ``stream_matmul``; the small per-layer leaves are
moved to the activations' device at use.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamBuilder, to_dtype, weight_matmul
from repro_torch.models.layers import rms_norm_vec, silu


# ---------------------------------------------------------------------------
# parameters and cache
# ---------------------------------------------------------------------------
def init_ssm(b: ParamBuilder, *, stacked: bool = False,
             layers: Optional[int] = None):
    cfg = b.cfg
    nL = layers if layers is not None else cfg.num_layers
    L = (nL,) if stacked else ()
    lr = ("none",) if stacked else ()
    di, N, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    b.add("in_zx", L + (cfg.d_model, 2 * di), lr + ("d_fsdp", "ssm_inner"))
    b.add("in_bcdt", L + (cfg.d_model, 2 * N + nh), lr + ("d_fsdp", "none"))
    b.add("conv_x", L + (cfg.conv_width, di), lr + ("none", "ssm_inner"))
    b.add("conv_bc", L + (cfg.conv_width, 2 * N), lr + ("none", "none"))
    b.add("A_log", L + (nh,), lr + ("ssm_inner",), init="zeros")
    b.add("dt_bias", L + (nh,), lr + ("ssm_inner",), init="zeros")
    b.add("D_skip", L + (nh,), lr + ("ssm_inner",), init="ones")
    b.add("ssm_norm", L + (di,), lr + ("ssm_inner",), init="ones")
    b.add("out_proj", L + (di, cfg.d_model), lr + ("ssm_inner", "d_fsdp"))


class SSMCache(NamedTuple):
    conv: torch.Tensor   # (B, W-1, di + 2N) rolling conv window
    state: torch.Tensor  # (B, nh, hp, N), fp32


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype, device=None,
                   layers: Optional[int] = None,
                   heads: Optional[int] = None) -> SSMCache:
    """Zero cache of one layer, or of ``layers`` stacked layers (leading
    dim). The state is fp32 whatever ``dtype`` is; it holds ``heads`` heads
    (a mesh rank's) where given, all of them by default."""
    di, N = cfg.d_inner, cfg.ssm_state
    nh, hp = heads or cfg.ssm_heads, cfg.ssm_head_dim
    L = (layers,) if layers is not None else ()
    return SSMCache(
        conv=torch.zeros(L + (batch, cfg.conv_width - 1, di + 2 * N),
                         dtype=to_dtype(dtype), device=device),
        state=torch.zeros(L + (batch, nh, hp, N), dtype=torch.float32,
                          device=device))


# ---------------------------------------------------------------------------
# projections shared by prefill & decode
# ---------------------------------------------------------------------------
def _proj_in(cfg: ModelConfig, p, u, heads: Optional[Tuple[int, int]] = None):
    """u: (B,S,D) -> z (B,S,di), xbc (B,S,di+2N) pre-conv, dt (B,S,nh).
    ``heads`` (h0, n): only heads h0..h0+n-1, from their z, x and dt columns
    of the whole ``in_zx`` and ``in_bcdt`` (di then n x hp)."""
    di, N = cfg.d_inner, cfg.ssm_state
    w_zx, w_bcdt = p["in_zx"], p["in_bcdt"]
    if heads is not None:
        h0, n = heads
        lo, hi = h0 * cfg.ssm_head_dim, (h0 + n) * cfg.ssm_head_dim
        w_zx = torch.cat([w_zx[:, lo:hi], w_zx[:, di + lo:di + hi]], dim=-1)
        w_bcdt = torch.cat([w_bcdt[:, :2 * N],
                            w_bcdt[:, 2 * N + h0:2 * N + h0 + n]], dim=-1)
        di = hi - lo
    zx = weight_matmul(u, w_zx)
    z, x = zx[..., :di], zx[..., di:]
    bcdt = weight_matmul(u, w_bcdt)
    bc, dt = bcdt[..., :2 * N], bcdt[..., 2 * N:]
    return z, torch.cat([x, bc], dim=-1), dt


def _causal_conv(cfg: ModelConfig, p, xbc, cache: Optional[torch.Tensor] = None):
    """Depthwise causal conv of width W over (B,S,C); optional cache prefix.
    Returns (silu(conv), the last W-1 rows of the padded input)."""
    W = cfg.conv_width
    kern = torch.cat([p["conv_x"], p["conv_bc"]], dim=-1).to(xbc.device, xbc.dtype)
    if cache is None:
        pad = torch.zeros((xbc.shape[0], W - 1, xbc.shape[-1]), dtype=xbc.dtype,
                          device=xbc.device)
    else:
        pad = cache.to(xbc.dtype)
    full = torch.cat([pad, xbc], dim=1)
    out = sum(full[:, i:i + xbc.shape[1], :] * kern[i] for i in range(W))
    return silu(out), full[:, -(W - 1):, :]


# ---------------------------------------------------------------------------
# chunked SSD (prefill), the reference's XLA-level algorithm
# ---------------------------------------------------------------------------
def ssd_chunked(x, dt, A, B_, C_, chunk: int,
                init_state: Optional[torch.Tensor] = None):
    """SSD scan. x: (B,S,nh,hp); dt: (B,S,nh) (already softplus+bias);
    A: (nh,) negative; B_, C_: (B,S,N). Returns (y, final_state); the state
    is (B, nh, hp, N), fp32. A ragged S is padded with dt = 0."""
    Bb, S, nh, hp = x.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    S_orig = S
    if S % Q:  # pad to a chunk multiple; dt=0 makes padding a no-op
        pad = Q - S % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, pad))
        S = S + pad
    nc = S // Q

    xf = x.float().reshape(Bb, nc, Q, nh, hp)
    dtf = dt.float().reshape(Bb, nc, Q, nh)
    Bf = B_.float().reshape(Bb, nc, Q, N)
    Cf = C_.float().reshape(Bb, nc, Q, N)
    Af = A.float()

    dA = dtf * Af                                          # (B,nc,Q,nh)
    cum = torch.cumsum(dA, dim=2)                          # within-chunk
    seg_total = cum[:, :, -1, :]                           # (B,nc,nh)

    # intra-chunk (matmul form): L[i,j] = exp(cum_i - cum_j) for i>=j. The
    # mask goes inside the exp: above the diagonal cum_i - cum_j > 0 can
    # overflow, and exp-then-mask (the reference's order, the same values)
    # gives 0 * inf = NaN in the gradient there
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,Q,nh)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    Lmat = torch.exp(torch.where(causal[None, None, :, :, None], diff,
                                 float("-inf")))
    G = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)            # (B,nc,Q,Q)
    M = G[..., None] * Lmat                                # (B,nc,Q,Q,nh)
    xdt = xf * dtf[..., None]                              # (B,nc,Q,nh,hp)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", M, xdt)

    # per-chunk input state contribution
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)   # (B,nc,Q,nh)
    S_chunk = torch.einsum("bcqn,bcqh,bcqhp->bchpn",
                           Bf, decay_to_end * dtf, xf)         # (B,nc,nh,hp,N)

    # inter-chunk recurrence (the reference's lax.scan)
    s = (torch.zeros((Bb, nh, hp, N), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    states_in = []
    for c in range(nc):
        states_in.append(s)                                    # entering c
        s = s * torch.exp(seg_total[:, c])[:, :, None, None] + S_chunk[:, c]
    states_in = torch.stack(states_in, dim=1)                  # (B,nc,nh,hp,N)

    # inter-chunk output: y_off = C_i * exp(cum_i) @ state_in
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cf, states_in, torch.exp(cum))
    y = (y_diag + y_off).reshape(Bb, S, nh, hp)[:, :S_orig]
    return y.to(x.dtype), s


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """One-token recurrence. state: (B,nh,hp,N); x_t: (B,nh,hp);
    dt_t: (B,nh); B_t, C_t: (B,N). Returns (new state, y (B,nh,hp))."""
    dA = torch.exp(dt_t.float() * A.float())                     # (B,nh)
    upd = torch.einsum("bn,bh,bhp->bhpn", B_t.float(), dt_t.float(),
                       x_t.float())
    state = state * dA[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return state, y.to(x_t.dtype)


def ssd_kernel(x, dt, A, B_, C_, chunk: int, init_state=None):
    """``ssd_chunked``'s contract on the hand-written ``ssd_scan`` kernel."""
    return kops.ssd(x.contiguous(), dt.contiguous(), A.contiguous(),
                    B_.contiguous(), C_.contiguous(), chunk=chunk,
                    init_state=init_state, return_state=True)


class _SSD(torch.autograd.Function):
    """(y, final state) = ``forward_fn(x, dt, A, B_, C_, chunk,
    init_state)``; the backward recomputes ``ssd_chunked`` on the saved
    inputs under autograd and returns its gradients."""

    @staticmethod
    def forward(ctx, forward_fn, chunk, x, dt, A, B_, C_, init_state):
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B_, C_, init_state)
        return forward_fn(x, dt, A, B_, C_, chunk, init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        ins = [None if t is None else t.detach().requires_grad_(n)
               for t, n in zip(saved, needs)]
        with torch.enable_grad():
            y, state = ssd_chunked(*ins[:5], ctx.chunk, init_state=ins[5])
        outs = [(o, g) for o, g in ((y, dy), (state, dstate)) if g is not None]
        want = [t for t, n in zip(ins, needs) if n]
        grads = iter(torch.autograd.grad([o for o, _ in outs],
                                         want, [g for _, g in outs],
                                         allow_unused=True)
                     if outs and want else [None] * len(want))
        return (None, None) + tuple(next(grads) if n else None for n in needs)


def ssd_autograd(forward_fn, x, dt, A, B_, C_, chunk: int,
                 init_state: Optional[torch.Tensor] = None):
    """The SSD scan as one autograd node: ``forward_fn`` (the kernel on the
    card, ``ssd_kernel``; any function with ``ssd_chunked``'s contract) makes
    (y, final state), and the gradients of x, dt, A, B_, C_ and, where it
    requires grad, ``init_state`` come from autograd through
    ``ssd_chunked`` recomputed on the same inputs."""
    return _SSD.apply(forward_fn, chunk, x, dt, A, B_, C_, init_state)


def _ssd_prefill(cfg: ModelConfig, xh, dt, A, B_, C_, init_state):
    """The prefill SSD by the route the device gives (module docstring)."""
    if xh.device.type == "cuda":
        return ssd_autograd(ssd_kernel, xh, dt, A, B_, C_, cfg.ssm_chunk,
                            init_state)
    return ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk, init_state=init_state)


# ---------------------------------------------------------------------------
# full layer
# ---------------------------------------------------------------------------
def _split_rms_norm(y, scale, eps: float, di: int, row_sum):
    """``rms_norm_vec`` over a row whose ``d_inner`` columns are split over
    ranks: y holds this rank's, ``row_sum`` sums the ranks' square sums."""
    yf = y.float()
    ms = row_sum(yf.square().sum(dim=-1, keepdim=True)) / di
    return (yf * torch.rsqrt(ms + eps)
            * scale.to(y.device, torch.float32)).to(y.dtype)


def apply_ssm(cfg: ModelConfig, p, u, cache: Optional[SSMCache] = None, *,
              heads: Optional[Tuple[int, int]] = None, row_sum=None,
              gather=None) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """Mamba2 block. u: (B,S,D). With ``cache`` and S == 1 it is the decode
    path, which updates ``cache`` in place and returns it; with ``cache``
    and S > 1 (prefill) a new cache is returned.

    ``heads`` (h0, n): a mesh rank's heads h0..h0+n-1 (all of them when
    None). ``p`` then holds ``in_zx`` and ``in_bcdt`` whole and the per-head
    leaves (``conv_x``, ``A_log``, ``dt_bias``, ``D_skip``, ``ssm_norm``,
    ``out_proj``'s rows) as those heads' slices; the state is theirs, the
    conv window stays whole (its x channels gathered by ``gather``), the
    gated norm's square sums are summed over the ranks by ``row_sum``, and
    the output is this rank's part of the out projection, which the caller
    sums over the ranks."""
    di, N, hp = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h0, nh = heads if heads is not None else (0, cfg.ssm_heads)
    split = nh != cfg.ssm_heads
    dl = nh * hp                                # this call's x channels
    dev = u.device
    z, xbc, dt = _proj_in(cfg, p, u, (h0, nh) if split else None)
    A = -torch.exp(p["A_log"].to(dev, torch.float32))
    # softplus in fp32 as the reference; torch's returns its input above 20
    # where jax's keeps log1p(exp(x)): they differ there by less than 1e-8
    dt = F.softplus(dt.float() + p["dt_bias"].to(dev, torch.float32))

    decode = cache is not None and u.shape[1] == 1
    prefix = cache.conv if decode else None
    if decode and split:
        lo = h0 * hp
        prefix = torch.cat([prefix[..., lo:lo + dl], prefix[..., di:]], dim=-1)
    xbc_conv, new_conv = _causal_conv(cfg, p, xbc, prefix)
    if split and cache is not None:
        new_conv = torch.cat([gather(new_conv[..., :dl]), new_conv[..., dl:]],
                             dim=-1)
    x = xbc_conv[..., :dl]
    B_ = xbc_conv[..., dl:dl + N]
    C_ = xbc_conv[..., dl + N:]
    xh = x.reshape(x.shape[0], x.shape[1], nh, hp)

    if decode:
        state, y = ssd_decode_step(cache.state, xh[:, 0], dt[:, 0], A,
                                   B_[:, 0], C_[:, 0])
        cache.conv.copy_(new_conv)
        cache.state.copy_(state)
        y = y[:, None]
        new_cache = cache
    else:
        y, state = _ssd_prefill(cfg, xh, dt, A, B_, C_,
                                cache.state if cache is not None else None)
        new_cache = SSMCache(conv=new_conv, state=state) if cache is not None else None

    D = p["D_skip"].to(dev, torch.float32)[None, None, :, None].to(y.dtype)
    y = (y + xh * D).reshape(u.shape[0], u.shape[1], dl)
    y = y * F.silu(z.float()).to(y.dtype)
    if split:
        y = _split_rms_norm(y, p["ssm_norm"], cfg.norm_eps, di, row_sum)
    else:
        y = rms_norm_vec(y, p["ssm_norm"], cfg.norm_eps)
    return weight_matmul(y, p["out_proj"]), new_cache
