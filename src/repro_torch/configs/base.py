"""Configuration dataclasses for the dense decoder family the port covers.

The dense-GQA part of ``repro.configs.base``, cut to the fields the port's
model, engine and launcher read (untied embeddings, no q/k norm, no
modality prefix; the dtype is the caller's).  Configs are frozen
dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AttnConfig:
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 10_000.0
    window: Optional[int] = None   # sliding-window size; None = full causal


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # only "dense" is ported
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    norm_eps: float = 1e-6
    source: str = ""               # citation of the published widths

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Vocab padded as the JAX package pads it; logits at padded ids are
    masked."""
    return ((v + multiple - 1) // multiple) * multiple
