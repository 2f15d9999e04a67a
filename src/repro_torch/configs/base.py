"""Configuration dataclasses for the families the port covers: dense GQA
decoders (with Qwen3's per-head q/k norm), mixture-of-experts decoders with
GQA or MLA (DeepSeek-V2's multi-head latent attention), Mamba-2 (SSD), the
encoder-decoder (SeamlessM4T) and the VLM (PaliGemma: a decoder behind a
prefix of modality embeddings).

The attention, MoE, SSM, encoder-decoder and modality-prefix parts of
``repro.configs.base``, cut to the fields the port's models, engine and
launchers read (untied embeddings).  The weights' and caches' dtype is the
caller's; ``dtype`` is read only where JAX reads it, the cast of an
encoder's ``src_embeds``.  Configs are frozen dataclasses.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class AttnConfig:
    kind: str = "gqa"              # "gqa" | "mla"
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: int = 128
    qk_norm: bool = False          # Qwen3-style per-head RMSNorm on q,k
    rope_theta: float = 10_000.0
    window: Optional[int] = None   # sliding-window size; None = full causal
    # --- MLA (DeepSeek-V2) ---
    kv_lora_rank: int = 0          # compressed KV dim (c_kv)
    q_lora_rank: int = 0           # 0 = full-rank q projection
    rope_head_dim: int = 64        # decoupled RoPE key/query dim
    v_head_dim: int = 0            # defaults to head_dim when 0

    @property
    def vdim(self) -> int:
        return self.v_head_dim or self.head_dim


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0              # DeepSeek-style always-on shared experts
    d_ff_shared: int = 0           # d_ff of the shared-expert block
    capacity_factor: float = 1.25  # GShard-style dispatch capacity
    router_aux_weight: float = 1e-2
    # dispatch implementation: "einsum" = GShard one-hot matmuls, "gather" =
    # stable-sort ragged dispatch; both drop the same tokens
    dispatch: str = "einsum"


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
    family: str                    # "dense", "moe", "ssm", "audio" or "vlm" (the families ported)
    n_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec only
    enc_layers: int = 0
    cross_attn: bool = False
    # vlm: number of modality-prefix embedding positions supplied by the
    # (stubbed) frontend, and whether the prefix mask is bidirectional
    prefix_len: int = 0
    bidirectional_prefix: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"        # an encoder casts src_embeds to it (JAX's encode)
    # int8 KV cache with per-(row, kv-head) scales (GQA caches only; MLA's
    # cache is already rank-compressed).  §Perf lever: halves the decode
    # cache sweep, the dominant memory term at 32k context.
    kv_quant: bool = False
    source: str = ""               # citation of the published widths

    @property
    def is_encdec(self) -> bool:
        """An encoder-decoder: built as ``EncDecLM``, its target takes
        ``src_embeds`` (JAX's ``encdec`` and ``audio`` families)."""
        return self.family in ("encdec", "audio")

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def pad_vocab(v: int, multiple: int = 512) -> int:
    """Vocab padded as the JAX package pads it; logits at padded ids are
    masked."""
    return ((v + multiple - 1) // multiple) * multiple
