"""phi3-mini-3.8b [arXiv:2404.14219; unverified]. RoPE, SwiGLU, GQA (kv=32 = MHA).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family=DENSE,
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    use_bias=False,
    glu=True,
    act="silu",
    rope_theta=10_000.0,
)
