"""Plain PyTorch oracles for the kernels (the correctness ground truth)."""
from __future__ import annotations

import math

import torch


def attention_ref(q, k, v, *, causal: bool = True, scale=None):
    """Naive softmax attention. q, k, v: (BH, S, hd)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        Sq, Sk = s.shape[1], s.shape[2]
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])
        s = s.masked_fill(~mask[None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def ssd_ref(x, dt, A, B_, C_):
    """Naive sequential SSD recurrence (fp32), one token at a time.
    x: (B,S,nh,hp); dt: (B,S,nh); A: (nh,); B_, C_: (B,S,N)."""
    Bb, S, nh, hp = x.shape
    N = B_.shape[-1]
    xf, dtf, Af, Bf, Cf = x.float(), dt.float(), A.float(), B_.float(), C_.float()
    state = torch.zeros((Bb, nh, hp, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dtf[:, t] * Af[None, :])                  # (B,nh)
        upd = torch.einsum("bn,bh,bhp->bhpn", Bf[:, t], dtf[:, t], xf[:, t])
        state = state * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", state, Cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype)                      # (B,S,nh,hp)


def gmm_ref(x, w):
    """x: (E, C, d); w: (E, d, f)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def matmul_ref(x, w):
    return (x.float() @ w.float()).to(x.dtype)
