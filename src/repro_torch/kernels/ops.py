"""Public wrappers of the kernels, in the layouts the models use."""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import stream_matmul as _sm


def flash_attention(q, k, v, *, causal: bool = True):
    """q, k, v: (B, S, H, hd) — heads are folded/unfolded here."""
    B, S, H, hd = q.shape
    fold = lambda t: t.permute(0, 2, 1, 3).reshape(
        B * H, t.shape[1], hd).contiguous()
    out = _fa.flash_attention_fwd(fold(q), fold(k), fold(v), causal=causal)
    return out.reshape(B, H, S, hd).permute(0, 2, 1, 3)


def stream_matmul(x, w, *, block_k: int = _sm.BLOCK_K):
    """x: (M, K) resident; w: (K, N) on x's device or in pinned host memory,
    streamed in ``block_k`` panels."""
    return _sm.stream_matmul(x, w, block_k=block_k)
