"""internvl2-76b [vlm]: InternViT (STUBBED) + Llama-3-70B-style LM. [arXiv:2404.16821]

The port's copy of ``repro/configs/internvl2_76b.py``. 80 layers,
d_model=8192, GQA 64/8 (head dim 128), d_ff=28672, vocab=128256, untied
head, RoPE θ 5·10⁵. The vision encoder and its MLP projector are a stub:
the LM reads ``vision_tokens`` precomputed patch embeddings of shape
(batch, 256, d_model), projected by ``vision_proj`` and prepended to the
token embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="arXiv:2404.16821",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    vision_tokens=256,
    rope=True,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=32_768,
)
