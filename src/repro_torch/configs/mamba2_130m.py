"""mamba2-130m [arXiv:2405.21060; unverified]. SSD (state-space duality), attn-free.

24L d_model=768, ssm_state=128, vocab=50280, d_inner=1536, 24 SSD heads of 64.
"""
from repro_torch.configs.base import SSM, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family=SSM,
    num_layers=24,
    d_model=768,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_width=4,
    ssm_chunk=128,
    tie_embeddings=True,
)
