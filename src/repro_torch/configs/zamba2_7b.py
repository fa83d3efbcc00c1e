"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

The port's copy of ``repro/configs/zamba2_7b.py``. 81 Mamba2 layers with
ONE parameter-shared attention+MLP block applied periodically (every 6
mamba layers here). ssm_state=64, GQA kv=32 on the shared block.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    source="arXiv:2411.15242",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14_336,
    vocab_size=32_000,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,
    ssm_head_dim=64,
    attn_every=6,
    rope=True,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=1_048_576,
)
