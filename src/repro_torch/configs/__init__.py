"""Model configurations: the dataclasses and the registered architectures
(the OPT pair, yi-9b, internlm2-1.8b)."""
from repro_torch.configs.base import AttnConfig, ModelConfig, pad_vocab
from repro_torch.configs.registry import (get_config, get_draft_config,
                                          get_smoke_config)
