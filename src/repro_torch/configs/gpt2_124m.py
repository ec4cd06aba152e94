"""gpt2-124m — the paper's own LLM-training workload (llm.c, paper Table III).

12L d_model=768 12H d_ff=3072 vocab=50257, learned positions, GELU MLP.
"""
from repro_torch.configs.base import DENSE, ModelConfig

CONFIG = ModelConfig(
    name="gpt2-124m",
    family=DENSE,
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=50257,
    use_bias=True,
    glu=False,
    act="gelu",
    norm="layernorm",
    learned_pos=True,
    max_position=1024,
    tie_embeddings=True,
)
