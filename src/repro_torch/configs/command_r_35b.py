"""command-r-35b [hf:CohereForAI/c4ai-command-r-v01; unverified]. GQA, no-bias.

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family=DENSE,
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256000,
    use_bias=False,
    glu=True,
    act="silu",
    tie_embeddings=True,
    norm="layernorm",
    rope_theta=8_000_000.0,
)
