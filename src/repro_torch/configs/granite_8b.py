"""granite-8b [dense]: llama-arch code model, GQA kv=8. [arXiv:2405.04324]

The port's copy of ``repro/configs/granite_8b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-8b",
    family="dense",
    source="arXiv:2405.04324",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14_336,
    vocab_size=49_152,
    rope=True,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=8_192,
)
