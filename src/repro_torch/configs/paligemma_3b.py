"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=257216,
SigLIP + gemma.  [arXiv:2407.07726]

The SigLIP vision tower and projector are a stub, as in the JAX package: the
target takes 256 precomputed patch embeddings ``prefix_embeds [B, 256,
2048]`` that form a bidirectional prefix (PaliGemma's prefix-LM masking);
speculation runs on the text suffix, and the draft is text-only.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "paligemma-3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        n_layers=18, d_model=2048, d_ff=16_384, vocab_size=257_216,
        attn=AttnConfig(n_heads=8, n_kv_heads=1, head_dim=256, rope_theta=1e4),
        prefix_len=256, bidirectional_prefix=True,
        source="arXiv:2407.07726",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=128, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=32, rope_theta=1e4),
        prefix_len=8, bidirectional_prefix=True,
        dtype="float32",
        source="reduced paligemma family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
