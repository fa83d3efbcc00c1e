"""qwen2.5-3b [dense]: GQA kv=2, QKV bias. [hf:Qwen/Qwen2.5-0.5B]

The port's copy of ``repro/configs/qwen2_5_3b.py`` (the reference serve's
default arch is its ``-smoke`` variant).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    source="hf:Qwen/Qwen2.5-0.5B",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11_008,
    vocab_size=151_936,
    rope=True,
    rope_theta=1_000_000.0,
    qkv_bias=True,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=32_768,
    tie_embeddings=True,
)
