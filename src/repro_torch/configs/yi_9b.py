"""yi-9b [dense]: 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
[arXiv:2403.04652]  The port registers it for its smoke config, which covers
GQA with more than one query head per kv-head."""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "yi-9b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=4096, d_ff=11_008, vocab_size=64_000,
        attn=AttnConfig(n_heads=32, n_kv_heads=4, head_dim=128, rope_theta=5e6),
        source="arXiv:2403.04652",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, d_ff=352, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32, rope_theta=5e6),
        source="reduced yi family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
