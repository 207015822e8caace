"""Architecture registry of the port: ``get(name)`` -> ModelConfig.

Every architecture of the reference is registered: the decoders and
mamba2 / zamba2 are served and trained, hubert-xlarge (encoder-only, the
frames frontend) is trained only.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS: list[str] = ["qwen2_0_5b", "mamba2_2_7b", "qwen1_5_4b",
                        "chatglm3_6b", "gemma2_9b", "llava_next_mistral_7b",
                        "zamba2_7b", "llama4_scout_17b_a16e",
                        "deepseek_v2_236b", "hubert_xlarge"]

#: accepted aliases (the dashed ids)
ALIASES: dict[str, str] = {"qwen2-0.5b": "qwen2_0_5b",
                            "mamba2-2.7b": "mamba2_2_7b",
                            "qwen1.5-4b": "qwen1_5_4b",
                            "chatglm3-6b": "chatglm3_6b",
                            "gemma2-9b": "gemma2_9b",
                            "llava-next-mistral-7b": "llava_next_mistral_7b",
                            "zamba2-7b": "zamba2_7b",
                            "llama4-scout-17b-16e": "llama4_scout_17b_a16e",
                            "deepseek-v2-236b": "deepseek_v2_236b",
                            "hubert-xlarge": "hubert_xlarge"}

__all__ = ["ALIASES", "ARCH_IDS", "get"]


def get(name: str) -> ModelConfig:
    key = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if key not in ARCH_IDS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG.validate()
