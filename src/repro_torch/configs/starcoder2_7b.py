"""starcoder2-7b [arXiv:2402.19173; hf]. GQA, RoPE, plain-MLP with GELU.

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family=DENSE,
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    use_bias=True,
    glu=False,
    act="gelu",
    norm="layernorm",
    rope_theta=100_000.0,
)
