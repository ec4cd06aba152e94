"""zamba2-1.2b [arXiv:2411.15242; hf]. Mamba2 backbone + shared attention block.

38 Mamba2 layers d_model=2048, ssm_state=64; one SHARED attention+MLP block
(32H kv=32, d_ff=8192) invoked every 6 SSM layers (weights reused each time).
"""
from repro_torch.configs.base import HYBRID, ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family=HYBRID,
    num_layers=38,           # Mamba2 layers
    attn_every=6,            # shared attn block applied after every 6th layer
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    use_bias=False,
    glu=True,
    act="silu",
    tie_embeddings=True,
)
