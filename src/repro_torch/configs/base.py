"""Configuration dataclasses for the families the port covers: dense GQA
decoders and Mamba-2 (SSD).

The dense-GQA and SSM parts of ``repro.configs.base``, cut to the fields
the port's models, engine and launchers read (untied embeddings, no q/k
norm, no modality prefix; the dtype is the caller's).  Configs are frozen
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
class SSMConfig:
    """Mamba-2 SSD parameters."""
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256               # SSD chunk length
    d_conv: int = 4
    n_groups: int = 1


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "dense" or "ssm" (the families ported)
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    ssm: Optional[SSMConfig] = None
    norm_eps: float = 1e-6
    source: str = ""               # citation of the published widths

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Vocab padded as the JAX package pads it; logits at padded ids are
    masked."""
    return ((v + multiple - 1) // multiple) * multiple
