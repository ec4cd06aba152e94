"""Public wrappers of the kernels, in the layouts the models use."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import grouped_matmul as _gmm
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import stream_matmul as _sm


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q: (B, Sq, H, hd), k, v: (B, Sk, H, hd) — heads are folded/unfolded
    here. ``q_offset``: the causal mask's position of query row 0."""
    B, S, H, hd = q.shape
    fold = lambda t: t.permute(0, 2, 1, 3).reshape(
        B * H, t.shape[1], hd).contiguous()
    out = _fa.flash_attention_fwd(fold(q), fold(k), fold(v), causal=causal,
                                  q_offset=q_offset)
    return out.reshape(B, H, S, hd).permute(0, 2, 1, 3)


def flash_attention_grads(q, k, v, dout, *, causal: bool = True):
    """Full flash backward through the kernels, the reference's
    ``ops.flash_attention_grads``. q, k, v, dout: (BH, S, hd).
    Returns (out, dq, dk, dv)."""
    out, lse = _fa.flash_attention_fwd_stats(q, k, v, causal=causal)
    dq, dk, dv = _fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    return out, dq, dk, dv


def stream_matmul(x, w, *, block_k=None):
    """x: (M, K) resident; w: (K, N) on x's device or in pinned host memory,
    streamed in panels of ``block_k`` rows (the wrapper's byte-sized panels
    when None)."""
    return _sm.stream_matmul(x, w, block_k=block_k)


def grouped_matmul(x, w):
    """x: (E, C, d) capacity buffers (any expert stride: 0 shares one x);
    w: (E, d, f) expert weights on x's device or in pinned host memory,
    streamed in panels of ``grouped_matmul.BLOCK_K`` rows."""
    return _gmm.grouped_matmul(x, w)


def ssd(x, dt, A, B_, C_, *, chunk: int = 128, nh_block=None,
        init_state=None, return_state: bool = False):
    """Mamba2 SSD scan. x: (B, S, nh, hp); dt: (B, S, nh); A: (nh,);
    B_, C_: (B, S, N). Returns y, or (y, final_state) with ``return_state``;
    ``init_state`` (B, nh, hp, N) fp32 starts the scan (zero when None)."""
    return _ssd.ssd_scan(x, dt, A, B_, C_, chunk=chunk, nh_block=nh_block,
                         init_state=init_state, return_state=return_state)
