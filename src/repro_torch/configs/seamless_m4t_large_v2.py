"""seamless-m4t-large-v2 [audio]: 24L d_model=1024 16H (GQA kv=16) d_ff=8192
vocab=256206, encoder-decoder, multimodal.  [arXiv:2308.11596]

Realized as 24 encoder + 24 decoder layers (the HF card's text-decoder
depth), as the JAX package builds it.  The speech frontend (mel-spectrogram
+ conv feature extractor) is a stub: the encoder takes precomputed frame
embeddings ``src_embeds`` [B, S, 1024].
"""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="audio",
        n_layers=24, enc_layers=24, cross_attn=True,
        d_model=1024, d_ff=8192, vocab_size=256_206,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64, rope_theta=1e4),
        source="arXiv:2308.11596",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, enc_layers=2, cross_attn=True,
        d_model=128, d_ff=256, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32, rope_theta=1e4),
        dtype="float32",
        source="reduced seamless family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    # drafting happens on the decoder: a dense decoder-only draft predicts
    # target tokens from the committed prefix (no cross-attention; it only
    # proposes, the enc-dec target verifies)
    return dense_draft(config())
