"""yi-34b [dense]: 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000,
llama-arch GQA.  [arXiv:2403.04652]  Seven query heads per kv-head."""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "yi-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=60, d_model=7168, d_ff=20_480, vocab_size=64_000,
        attn=AttnConfig(n_heads=56, n_kv_heads=8, head_dim=128, rope_theta=5e6),
        source="arXiv:2403.04652",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=224, d_ff=640, vocab_size=512,
        attn=AttnConfig(n_heads=7, n_kv_heads=1, head_dim=32, rope_theta=5e6),
        source="reduced yi family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
