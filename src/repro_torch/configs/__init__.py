"""Config registry of the port: the paper's own models, every dense
model of the reference's registry, its two MoE models, its hybrid one, its
xLSTM one, its encoder-decoder one and its vision-language one, and the
four assigned input shapes.

``get_config(name)`` covers ``paper-tiny``, ``paper-gpt2``,
``paper-llama3.2-3b``, ``qwen2.5-3b``, ``granite-8b``, ``starcoder2-15b``,
``gemma3-12b``, ``mixtral-8x22b``, ``deepseek-v2-236b``, ``zamba2-7b``,
``xlstm-1.3b``, ``whisper-medium`` and ``internvl2-76b``, the reference's
thirteen names (``<name>-smoke`` gives the reduced variant), with the
reference's dataclasses copied in :mod:`repro_torch.configs.base`;
``ASSIGNED`` is the reference's pool of ten assigned architectures and
``get_shape`` its four shapes (:mod:`repro_torch.configs.shapes`).
"""

from repro_torch.configs.base import (FedConfig, LoRAConfig, ModelConfig,
                                      ServeConfig, ShapeConfig, TrainConfig,
                                      config_dict, validate_fed_lora)
from repro_torch.configs.shapes import SHAPES, get_shape
from repro_torch.util.registry import Registry

CONFIGS: Registry = Registry("model-configs")

from repro_torch.configs import (deepseek_v2_236b, gemma3_12b,  # noqa: E402
                                 granite_8b, internvl2_76b, mixtral_8x22b,
                                 paper_models, qwen2_5_3b, starcoder2_15b,
                                 whisper_medium, xlstm_1_3b, zamba2_7b)

# The ten assigned architectures.
ASSIGNED = {
    "whisper-medium": whisper_medium.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "granite-8b": granite_8b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
    "gemma3-12b": gemma3_12b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
}

for _name, _cfg in {**ASSIGNED,
                    "paper-gpt2": paper_models.GPT2_SMALL,
                    "paper-llama3.2-3b": paper_models.LLAMA32_3B,
                    "paper-tiny": paper_models.TINY}.items():
    CONFIGS.register(_name)(_cfg)


def get_config(name: str) -> ModelConfig:
    """Look up a model config; ``<name>-smoke`` returns the reduced variant."""
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    return CONFIGS.get(name)


def list_configs():
    return CONFIGS.names()


__all__ = ["ASSIGNED", "CONFIGS", "FedConfig", "LoRAConfig", "ModelConfig",
           "SHAPES", "ServeConfig", "ShapeConfig", "TrainConfig",
           "config_dict", "get_config", "get_shape", "list_configs",
           "validate_fed_lora"]
