"""Model configurations: the dataclasses and the two registered pairs."""
from repro_torch.configs.base import AttnConfig, ModelConfig, pad_vocab
from repro_torch.configs.registry import (get_config, get_draft_config,
                                          get_smoke_config)
