"""gemma3-12b [dense]: 5:1 local:global attention, 128k ctx. [hf:google/gemma-3-1b-pt]

head_dim=256 (decoupled from d_model), local layers use a 1024-token sliding
window; every 6th layer is global.

The port's copy of ``repro/configs/gemma3_12b.py``.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    source="hf:google/gemma-3-1b-pt",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    rope=True,
    rope_theta=1_000_000.0,
    local_global_ratio=5,
    local_window=1024,
    norm="rmsnorm",
    act="gelu",
    max_position_embeddings=131_072,
    tie_embeddings=True,
)
