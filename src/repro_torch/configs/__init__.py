"""Architecture config registry of the port: every arch of the JAX
package's registry."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    MoEConfig,
    SSMConfig,
)

_REGISTRY = {
    "qwen2-vl-72b": "qwen2_vl_72b",
    "whisper-medium": "whisper_medium",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "qwen2-1.5b": "qwen2_1_5b",
    "gemma3-12b": "gemma3_12b",
    "qwen3-32b": "qwen3_32b",
    "command-r-35b": "command_r_35b",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "mamba2-2.7b": "mamba2_2_7b",
}

ARCH_IDS = list(_REGISTRY)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in _REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; "
                       f"known: {sorted(_REGISTRY)}")
    mod = importlib.import_module(f"repro_torch.configs.{_REGISTRY[arch]}")
    return mod.SMOKE_CONFIG if smoke else mod.CONFIG
