"""qwen3-32b [hf:Qwen/Qwen3-8B family scaling; hf]. qk_norm, GQA, SwiGLU.

64L d_model=5120 64H (GQA kv=8) d_ff=25600 vocab=151936.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family=DENSE,
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    use_qk_norm=True,
    use_bias=False,
    glu=True,
    act="silu",
    rope_theta=1_000_000.0,
)
