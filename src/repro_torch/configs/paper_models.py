"""The paper's own evaluation models, expressed in our config system.

FedEx-LoRA evaluates on RoBERTa-base/large (NLU), GPT-2 (NLG), and
Mistral-7B / Gemma-2 9B / Llama-3.2 3B (instruction tuning). We include
decoder-only equivalents for GPT-2 and Llama-3.2 3B as first-class configs so
the paper's federated experiments can be run end-to-end in this framework, plus
a tiny variant used by examples/tests (the paper's math is size-independent).
The port's copy of ``repro/configs/paper_models.py``.
"""

from repro_torch.configs.base import ModelConfig

GPT2_SMALL = ModelConfig(
    name="paper-gpt2",
    family="dense",
    source="arXiv:1905.00537 (GPT-2 124M, paper §5.3)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    d_ff=3072,
    vocab_size=50_257,
    rope=False,
    learned_pos_embeddings=True,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    max_position_embeddings=1024,
    tie_embeddings=True,
)

LLAMA32_3B = ModelConfig(
    name="paper-llama3.2-3b",
    family="dense",
    source="arXiv:2407.21783 (paper §5.1 commonsense)",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=128_256,
    rope=True,
    rope_theta=500_000.0,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=131_072,
    tie_embeddings=True,
)

# Tiny decoder used by examples, federated-convergence benchmarks and tests:
# the aggregation math the paper proves is size-independent.
TINY = ModelConfig(
    name="paper-tiny",
    family="dense",
    source="framework-internal (paper math is size-independent)",
    num_layers=4,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    d_ff=256,
    vocab_size=512,
    rope=True,
    norm="rmsnorm",
    act="silu",
    max_position_embeddings=2048,
    tie_embeddings=True,
)
