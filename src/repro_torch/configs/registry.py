"""``--arch <id>`` resolution for the port: the paper's OPT pair and yi-9b."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "opt-6.7b": "repro_torch.configs.opt_pair",
    "yi-9b": "repro_torch.configs.yi_9b",
}


def _module(arch_id: str):
    a = arch_id.lower().replace("_", "-")
    if a not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[a])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).config()


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke_config()


def get_draft_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).draft_config()
