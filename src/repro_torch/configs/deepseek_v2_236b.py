"""deepseek-v2-236b [moe]: MLA kv_lora=512, 2 shared + 160 routed top-6. [arXiv:2405.04434]

The port's copy of ``repro/configs/deepseek_v2_236b.py``. Multi-head
Latent Attention: KV compressed to kv_lora_rank=512 (+ decoupled RoPE key
of dim 64); queries via q_lora_rank=1536. First layer is dense
(d_ff=12288); remaining layers are MoE with per-expert hidden 1536.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    source="arXiv:2405.04434",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: kv heads == heads post-decompression
    d_ff=1536,
    vocab_size=102_400,
    mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=160,
    num_experts_per_tok=6,
    num_shared_experts=2,
    moe_d_ff=1536,
    first_k_dense=1,
    dense_d_ff=12_288,
    rope=True,
    rope_theta=10_000.0,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=131_072,
)
