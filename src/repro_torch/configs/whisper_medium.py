"""whisper-medium [audio]: enc-dec, conv/mel frontend STUBBED. [arXiv:2212.04356]

The port's copy of ``repro/configs/whisper_medium.py``. 24 encoder + 24
decoder layers, d_model=1024, 16 heads (MHA, kv=16), d_ff=4096,
vocab=51865, learned positional embeddings, LayerNorm + GELU. The
mel-spectrogram + conv feature extractor is a stub: the encoder reads
precomputed frame embeddings of shape (batch, enc_seq_len, d_model).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    source="arXiv:2212.04356",
    num_layers=24,  # decoder layers
    enc_layers=24,
    enc_seq_len=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51_865,
    rope=False,
    learned_pos_embeddings=True,
    qkv_bias=True,
    norm="layernorm",
    act="gelu",
    max_position_embeddings=32_768,
    tie_embeddings=True,
)
