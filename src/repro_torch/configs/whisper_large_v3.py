"""whisper-large-v3 [arXiv:2212.04356; unverified]. Encoder-decoder backbone.

32L (enc) + 32L (dec), d_model=1280 20H (kv=20, MHA) d_ff=5120 vocab=51866.
The conv audio frontend is a STUB: ``input_specs()`` provides precomputed
frame embeddings of shape (batch, encoder_seq, d_model).
"""
from repro_torch.configs.base import ENCDEC, ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family=ENCDEC,
    num_layers=32,           # decoder layers
    encoder_layers=32,
    encoder_seq=1500,        # 30 s of audio at 50 Hz after the conv stub
    d_model=1280,
    num_heads=20,
    num_kv_heads=20,
    head_dim=64,
    d_ff=5120,
    vocab_size=51866,
    use_bias=True,
    glu=False,
    act="gelu",
    norm="layernorm",
    learned_pos=True,
    max_position=1 << 16,
    tie_embeddings=True,
)
