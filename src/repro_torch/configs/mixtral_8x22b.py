"""mixtral-8x22b [moe]: 8 experts top-2, GQA kv=8, SWA. [arXiv:2401.04088]

The port's copy of ``repro/configs/mixtral_8x22b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    source="arXiv:2401.04088",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16_384,
    vocab_size=32_768,
    num_experts=8,
    num_experts_per_tok=2,
    moe_d_ff=16_384,
    rope=True,
    rope_theta=1_000_000.0,
    sliding_window=4_096,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=65_536,
)
