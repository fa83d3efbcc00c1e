"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks (7:1 ratio), no separate FFN. [arXiv:2405.04517]

The port's copy of ``repro/configs/xlstm_1_3b.py``. 48 blocks,
d_model=2048, 4 heads. Period of 8: 7 mLSTM (matrix-memory, parallel
linear-attention-style) + 1 sLSTM (scalar-memory recurrence).
d_ff=0 — projection up/down lives inside the blocks (expand factor 2).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    source="arXiv:2405.04517",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50_304,
    slstm_every=8,
    ssm_expand=2,
    rope=False,
    norm="layernorm",
    act="gelu",
    max_position_embeddings=1_048_576,
    tie_embeddings=True,
)
