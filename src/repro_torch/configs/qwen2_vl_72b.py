"""qwen2-vl-72b [arXiv:2409.12191; hf]. VLM backbone: M-RoPE, dynamic resolution.

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064. The vision frontend is
a STUB: ``input_specs()`` provides precomputed patch embeddings plus the three
M-RoPE position streams (temporal / height / width).
"""
from repro_torch.configs.base import VLM, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family=VLM,
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    mrope=True,
    use_bias=False,
    glu=True,
    act="silu",
    rope_theta=1_000_000.0,
    # 80 layers × d_model 8192: layer-boundary activations exceed HBM even at
    # maximum microbatching — sequence-sharded residuals are required to fit
    # (see DESIGN.md §5 and EXPERIMENTS.md §Dry-run).
    seq_shard_residuals=True,
)
