"""starcoder2-15b [dense]: GQA kv=4, RoPE, attention+MLP bias. [arXiv:2402.19173]

The port's copy of ``repro/configs/starcoder2_15b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24_576,
    vocab_size=49_152,
    rope=True,
    rope_theta=100_000.0,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    max_position_embeddings=16_384,
)
