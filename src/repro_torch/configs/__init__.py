"""Config registry of the port: the paper's own models, every dense
model of the reference's registry, its two MoE models, its hybrid one, its
xLSTM one, its encoder-decoder one and its vision-language one.

``get_config(name)`` covers ``paper-tiny``, ``paper-gpt2``,
``paper-llama3.2-3b``, ``qwen2.5-3b``, ``granite-8b``, ``starcoder2-15b``,
``gemma3-12b``, ``mixtral-8x22b``, ``deepseek-v2-236b``, ``zamba2-7b``,
``xlstm-1.3b``, ``whisper-medium`` and ``internvl2-76b``, the reference's
thirteen names (``<name>-smoke`` gives the reduced variant), with the
reference's dataclasses copied in :mod:`repro_torch.configs.base`.
"""

from repro_torch.configs import (deepseek_v2_236b, gemma3_12b, granite_8b,
                                 internvl2_76b, mixtral_8x22b, paper_models,
                                 qwen2_5_3b, starcoder2_15b, whisper_medium,
                                 xlstm_1_3b, zamba2_7b)
from repro_torch.configs.base import (FedConfig, LoRAConfig, ModelConfig,
                                      ServeConfig, TrainConfig, config_dict,
                                      validate_fed_lora)

CONFIGS = {
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "gemma3-12b": gemma3_12b.CONFIG,
    "granite-8b": granite_8b.CONFIG,
    "internvl2-76b": internvl2_76b.CONFIG,
    "mixtral-8x22b": mixtral_8x22b.CONFIG,
    "paper-gpt2": paper_models.GPT2_SMALL,
    "paper-llama3.2-3b": paper_models.LLAMA32_3B,
    "paper-tiny": paper_models.TINY,
    "qwen2.5-3b": qwen2_5_3b.CONFIG,
    "starcoder2-15b": starcoder2_15b.CONFIG,
    "whisper-medium": whisper_medium.CONFIG,
    "xlstm-1.3b": xlstm_1_3b.CONFIG,
    "zamba2-7b": zamba2_7b.CONFIG,
}


def get_config(name: str) -> ModelConfig:
    """Look up a model config; ``<name>-smoke`` returns the reduced variant."""
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).reduced()
    try:
        return CONFIGS[name]
    except KeyError:
        raise KeyError(f"model-configs: unknown entry {name!r} "
                       f"(known: {', '.join(sorted(CONFIGS))})") from None


def list_configs():
    return sorted(CONFIGS)


__all__ = ["CONFIGS", "FedConfig", "LoRAConfig", "ModelConfig", "ServeConfig",
           "TrainConfig", "config_dict", "get_config", "list_configs",
           "validate_fed_lora"]
