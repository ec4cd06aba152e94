"""llama3-8b — the paper's own LLM-inference workload (llama.cpp, paper Table III).

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b",
    family=DENSE,
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    use_bias=False,
    glu=True,
    act="silu",
    rope_theta=500_000.0,
)
