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


def matmul_ref(x, w):
    return (x.float() @ w.float()).to(x.dtype)
