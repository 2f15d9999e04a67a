"""Model configurations: the dataclasses and the registered architectures
(the OPT pair, yi-9b, yi-34b, qwen3-8b, qwen3-moe-30b-a3b, internlm2-1.8b,
mamba2-1.3b)."""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, SSMConfig, pad_vocab
from repro_torch.configs.registry import (build_model, get_config, get_draft_config,
                                          get_smoke_config)
