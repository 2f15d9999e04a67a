"""``--arch <id>`` resolution for the port: the paper's OPT pair, yi-9b,
yi-34b, qwen3-8b, qwen3-moe-30b-a3b, deepseek-v2-236b (MLA),
internlm2-1.8b (the training launcher's default), mamba2-1.3b,
seamless-m4t-large-v2 (encoder-decoder) and paligemma-3b (VLM); and
``build_model``, the model class for a config's family."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "opt-6.7b": "repro_torch.configs.opt_pair",
    "yi-9b": "repro_torch.configs.yi_9b",
    "yi-34b": "repro_torch.configs.yi_34b",
    "qwen3-8b": "repro_torch.configs.qwen3_8b",
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "deepseek-v2-236b": "repro_torch.configs.deepseek_v2_236b",
    "internlm2-1.8b": "repro_torch.configs.internlm2_1_8b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1_3b",
    "seamless-m4t-large-v2": "repro_torch.configs.seamless_m4t_large_v2",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
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


def build_model(cfg: ModelConfig):
    """The model for a config's family: ``DecoderLM`` (dense, moe, vlm),
    ``Mamba2LM`` (ssm) or ``EncDecLM`` (encdec, audio), as
    ``repro.configs.registry.build_model``."""
    if cfg.family in ("dense", "moe", "vlm"):
        from repro_torch.models.transformer import DecoderLM
        return DecoderLM(cfg)
    if cfg.family == "ssm":
        from repro_torch.models.mamba2 import Mamba2LM
        return Mamba2LM(cfg)
    if cfg.is_encdec:
        from repro_torch.models.encdec import EncDecLM
        return EncDecLM(cfg)
    raise NotImplementedError(
        f"{cfg.name}: the {cfg.family!r} family is not ported yet "
        "(ROADMAP queue 1, item 12: recurrentgemma-2b)")
