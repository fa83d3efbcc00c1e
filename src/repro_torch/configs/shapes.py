"""The four assigned input shapes (the reference's ``configs/shapes.py``)."""

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode")

SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}") from None
