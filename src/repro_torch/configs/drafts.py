"""Draft ("small speculative model") config builder: a small dense GQA
decoder sharing the target's vocabulary, as ``repro.configs.drafts``.  Next
to a recurrent target the draft inherits a sliding window, so long-context
decode stays sub-quadratic end to end."""
from __future__ import annotations

from repro_torch.configs.base import AttnConfig, ModelConfig


def dense_draft(target: ModelConfig, *, n_layers: int = 4, d_model: int = 512,
                n_heads: int = 8, d_ff: int = 2048, window=None) -> ModelConfig:
    if window is None and target.attn is not None:
        window = target.attn.window
    if window is None and target.family in ("ssm", "hybrid"):
        window = 4096  # keep the draft sub-quadratic next to an O(1) target
    return ModelConfig(
        name=f"{target.name}-draft",
        family="dense",
        n_layers=n_layers,
        d_model=d_model,
        d_ff=d_ff,
        vocab_size=target.vocab_size,
        attn=AttnConfig(n_heads=n_heads, n_kv_heads=n_heads,
                        head_dim=d_model // n_heads, rope_theta=1e6,
                        window=window),
        norm_eps=target.norm_eps,
        source="draft model (paper §2: SSM), OPT-125M-scale dense decoder",
    )
